"""The port's serve driver end to end on the CPU, its checkpoint layout and
bit-for-bit round trip (bf16 included), and the refusal to run on the CPU
unless asked."""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke
from repro_torch.core import GlobalFS
from repro_torch.device import resolve_device
from repro_torch.launch import serve as serve_mod
from repro_torch.models import build_model


def _leaves(tree, pre=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{pre}{k}/")
    else:
        yield pre.rstrip("/"), tree


def test_serve_end_to_end_on_cpu():
    cfg = get_smoke("qwen3-14b")
    lines = []
    res = serve_mod.serve(cfg, requests=3, prompt_len=12, gen=5, seed=0, device="cpu",
                          log=lines.append)
    assert res["generated"] == (3, 5)
    assert res["tokens"].dtype == torch.int64
    assert int(res["tokens"].min()) >= 0 and int(res["tokens"].max()) < cfg.padded_vocab
    # everything published is staged: the manifest's leaf bytes, plus the
    # manifest itself and the COMMIT marker
    assert res["stage_bytes"] == res["published_bytes"]
    assert 0 < res["published_bytes"] - res["manifest_bytes"] < 64 << 10
    assert res["stage_modeled_s"] > 0 and res["load_modeled_s"] > 0
    assert [ln.split("]")[0] for ln in lines] == ["[registry", "[stage-in", "[serve"]
    # the staged weights are the seeded ones: same seed, same tokens
    again = serve_mod.serve(cfg, requests=3, prompt_len=12, gen=5, seed=0, device="cpu",
                            log=lambda s: None)
    assert torch.equal(again["tokens"], res["tokens"])


def test_serve_main_parses_flags():
    res = serve_mod.main(["--requests", "2", "--prompt-len", "8", "--gen", "3",
                          "--device", "cpu"])
    assert res["generated"] == (2, 3)


def test_entry_points_refuse_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        serve_mod.serve(get_smoke("qwen3-14b"), requests=1, prompt_len=4, gen=2)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        serve_mod.main(["--requests", "1"])
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_checkpoint_round_trip_bit_for_bit(dtype):
    cfg = dataclasses.replace(get_smoke("qwen3-14b"), dtype=dtype)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    fs = GlobalFS()
    try:
        mgr = CheckpointManager(fs, root="/ckpt", keep=2)
        man = mgr.save(0, {"params": params})
        restored, step = mgr.restore({"params": params})
        assert step == 0
        for (key, a), (key2, b) in zip(_leaves({"params": params}), _leaves(restored)):
            assert key == key2
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a.view(torch.int16) if dtype == "bfloat16" else a,
                               b.view(torch.int16) if dtype == "bfloat16" else b), key
        # the layout repro's manager writes: one .npy per leaf named by its
        # key path, a manifest, a COMMIT marker
        names = set(mgr.client.readdir("/ckpt/step-00000000"))
        keys = [m["key"] for m in man["leaves"]]
        assert keys == sorted(keys)
        assert "params/layers/attn/wq/w" in keys
        assert names == {m["file"] for m in man["leaves"]} | {"manifest.json", "COMMIT"}
        on_disk = json.loads(mgr.client.read_file("/ckpt/step-00000000/manifest.json"))
        assert on_disk["total_bytes"] == man["total_bytes"]
        assert {m["dtype"] for m in on_disk["leaves"]} == {dtype}
        # keep-k GC
        mgr.save(1, {"params": params})
        mgr.save(2, {"params": params})
        assert mgr.steps() == [1, 2]
    finally:
        fs.teardown()


def test_checkpoint_only_committed_steps_restore():
    fs = GlobalFS()
    try:
        mgr = CheckpointManager(fs, root="/ckpt")
        t = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
        mgr.save(0, t)
        mgr.save(1, t)
        mgr.client.unlink("/ckpt/step-00000001/COMMIT")        # a crash before commit
        assert mgr.steps() == [0]
        out, step = mgr.restore(t)
        assert step == 0 and torch.equal(out["w"], t["w"])
        np.testing.assert_array_equal(out["w"].numpy(), np.arange(6).reshape(2, 3))
    finally:
        fs.teardown()
