"""chip_smoke.py refuses to run anywhere but on a GPU."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def test_chip_smoke_exits_at_device_check_on_cpu() -> None:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")],
        cwd=ROOT,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
        check=False,
    )
    assert proc.returncode != 0
    assert "[device] FAIL platform is 'cpu'" in proc.stderr
    assert '"ok"' not in proc.stdout
    # stopped before importing the package or compiling anything
    assert "[main]" not in proc.stdout and "[device] import" not in proc.stdout
