"""The port's observed campaign examples (``examples/torch_chaos_campaign.py``,
``torch_slo_campaign.py``, ``torch_trace_campaign.py``,
``torch_serving_campaign.py``), each beside ``repro``'s: both exit 0, print
the same lines and write the same dashboards and traces under their own
names (tests/torch_campaign_examples.py)."""

import pytest

pytest.importorskip("torch")

from tests.torch_campaign_examples import check_pair  # noqa: E402


@pytest.mark.parametrize("stem", ["chaos_campaign", "slo_campaign", "trace_campaign",
                                  "serving_campaign"])
def test_example_prints_what_repros_prints(stem, tmp_path):
    check_pair(stem, tmp_path)
