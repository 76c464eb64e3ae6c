"""The training launcher as a user starts it over ranks:
``python -m torch.distributed.run --standalone --nproc-per-node 2 -m
repro_torch.launch.train ... --model-axis 2 --device cpu`` (gloo; world and
rank from the environment; rank 0 alone prints).  Its losses, as printed,
equal one rank's run of the same command line.  The launcher's sharded
state and its other meshes are held in ``tests/test_torch_train_mesh.py``.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

from repro_torch.launch import train as launcher

ROOT = Path(__file__).resolve().parents[1]
ARGV = ["--arch", "qwen2.5-3b", "--reduced", "--steps", "3", "--batch", "4",
        "--seq", "16", "--microbatch", "2", "--lr", "1e-3", "--dtype",
        "float32", "--adam-eps", "1e-6", "--device", "cpu", "--log-every",
        "1"]


def test_launcher_under_torch_distributed_run(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *ARGV,
         "--model-axis", "2", "--ckpt-dir", str(tmp_path)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    printed = [float(m) for m in re.findall(r"^step +\d+ +loss +(\S+)",
                                            out.stdout, re.M)]
    assert len(printed) == 3, out.stdout        # rank 0's lines alone
    want = launcher.run(ARGV)
    np.testing.assert_allclose(printed, want, rtol=0, atol=5e-5)
    assert (tmp_path / "step_00000003" / "host0.npz").exists()
