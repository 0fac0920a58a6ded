"""run.py from the command line: on a machine without a card it exits
non-zero and prints no result; on the card (gpu marker) a short run of
the smallest cell prints a correct result line."""
import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RUN = os.path.join(ROOT, "portbench", "run.py")


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run([sys.executable, RUN, "--workload",
                          "bubble3d.l1-256", "--seed", str(2 ** 31 + 3),
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA" in res.stderr


def test_unknown_workload_no_result():
    res = subprocess.run([sys.executable, RUN, "--workload", "nope",
                          "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.gpu
def test_card_run_small_cells():
    """The harness on the card at 32^3: the program correct against the
    reference, the float32 control not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, ROOT)
    from portbench import harness
    from portbench.tests.test_portbench_run import tiny
    for name in ("bubble3d.l1-256", "rt3d.l1-256"):
        c = tiny(name, 32)
        out = harness.run(c, 2 ** 31 + 11, 1.0, False)
        assert out["correct"], json.dumps(out["compared"])
        out = harness.run(c, 2 ** 31 + 11, 1.0, False, dtype="float32")
        assert not out["correct"], json.dumps(out["compared"])
