"""The port's campaign examples without a dashboard or trace artifact
(``examples/torch_quickstart.py``, ``torch_workflow_campaign.py``,
``torch_shared_dataset_campaign.py``) and the pilot campaign, each beside
``repro``'s: both exit 0 and print the same lines (tests/torch_campaign_examples.py)."""

import pytest

pytest.importorskip("torch")

from tests.torch_campaign_examples import check_pair  # noqa: E402


@pytest.mark.parametrize("stem", ["quickstart", "workflow_campaign", "shared_dataset_campaign",
                                  "pilot_campaign"])
def test_example_prints_what_repros_prints(stem, tmp_path):
    check_pair(stem, tmp_path)
