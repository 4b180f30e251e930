"""The dry run's CLI (``python -m repro_torch.launch.dryrun``) on one
production cell, rwkv6-7b ``train_4k`` on the fake 256-rank (32, 8) world,
the full-depth trace only (``--skip-probes``): it exits 0 and writes the
cell's JSON, which ``python -m repro_torch.launch.roofline`` tabulates.
A file of its own: the 32-layer trace on fake tensors takes about a
minute, and the dry run's other tests run beside it in another worker."""
import json
import os
import subprocess
import sys
from pathlib import Path

from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

ROOT = Path(__file__).resolve().parents[1]


def test_dryrun_cli_writes_its_json(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "rwkv6-7b", "--shape",
         "train_4k", "--skip-probes", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "[dryrun] all 1 cells OK" in out.stdout, out.stdout
    r = json.loads((tmp_path / "rwkv6-7b_train_4k_32x8_off.json").read_text())
    assert r["mesh"] == "32x8" and r["n_chips"] == 256 and r["mesh_axes"] == ["data", "model"]
    pd = r["per_device"]
    assert 0 < pd["argument_bytes"] <= pd["peak_bytes"] and pd["temp_bytes"] >= 0, pd
    assert pd["flops"] > 0 and r["fits"] is (pd["peak_bytes"] <= 80 * 2**30)
    # 32 layers, 2 microbatches: the forward and the recompute launch the
    # WKV, the backward its gradient
    assert r["kernels"]["wkv6_chunked"]["launches"] == 2 * 2 * 32
    assert r["kernels"]["wkv6_chunked_bwd"]["launches"] == 2 * 32
    coll = r["collectives"]["bytes_by_axis"]
    assert coll["model"]["all-gather"] > 0 and coll["data"]["reduce-scatter"] > 0, coll
    rl = r["roofline"]
    assert rl["bound_s"] == max(rl["t_compute_s"], rl["t_memory_s"], rl["t_collective_s"]) > 0
    table = subprocess.run([sys.executable, "-m", "repro_torch.launch.roofline", "--dir",
                            str(tmp_path)], capture_output=True, text=True, timeout=120, env=env)
    assert table.returncode == 0, table.stderr
    assert "| rwkv6-7b | train_4k | off | 32x8 |" in table.stdout, table.stdout
