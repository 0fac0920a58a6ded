"""tools/tier1_account.py, the pytest plugin that accounts for each test's
JAX compile work: a pytest run in a subprocess with the plugin loaded, on a
tiny test file whose two tests each jit a new function of the same body
and shapes, writes one JSON line a test with its compile seconds and keys,
and the summary lists that function's key as compiled twice, in two
tests of one file."""
import io
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import tier1_account  # noqa: E402

TINY = '''
import jax
import jax.numpy as jnp


def _jit_anew():
    def twice(x):
        return jnp.sin(x) * 2.0
    return jax.jit(twice)(jnp.ones((4, 3)))


def test_first():
    assert _jit_anew().shape == (4, 3)


def test_second():
    assert _jit_anew().shape == (4, 3)


def test_no_jax():
    assert 1 + 1 == 2
'''


def test_plugin_writes_a_line_a_test_and_finds_the_repeated_compile(
        tmp_path):
    (tmp_path / "test_tiny.py").write_text(TINY)
    out = tmp_path / "account.jsonl"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST_XDIST")}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "tools"),
               **{tier1_account.ENV: str(out)})
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "tier1_account",
         "-p", "no:cacheprovider", "test_tiny.py"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "3 passed" in res.stdout

    lines = [json.loads(x) for x in out.read_text().splitlines()]
    tests, sessions = tier1_account.load(out)
    assert len(lines) == len(tests) + len(sessions)
    assert [s["session"] for s in sessions] == ["main"]
    by_name = {t["nodeid"].split("::")[-1]: t for t in tests}
    assert set(by_name) == {"test_first", "test_second", "test_no_jax"}
    for t in by_name.values():
        assert t["file"] == "test_tiny.py" and t["outcome"] == "passed"
        assert t["end"] >= t["start"] and t["wall"] >= 0.0
        for k in ("trace_s", "lower_s", "backend_s", "saved_s", "hits",
                  "misses"):
            assert t[k] >= 0
    first, second = by_name["test_first"], by_name["test_second"]
    assert by_name["test_no_jax"]["compiles"] == []
    for t in (first, second):
        assert t["trace_s"] > 0.0 and t["backend_s"] > 0.0
        assert any(c[0].startswith("jit_twice") or
                   c[0].startswith("jit(twice)") for c in t["compiles"])

    rep = tier1_account.repeated(tests)
    twice = [k for k in rep if "twice" in k]
    assert len(twice) == 1
    e = rep[twice[0]]
    assert e["n"] == 2 and len(e["tests"]) == 2
    assert e["files"] == {"test_tiny.py"} and e["sig"] == "float32[4,3]"

    text = io.StringIO()
    tier1_account.summary(out, top=25, out=text)
    text = text.getvalue()
    assert "tests 3 " in text and "| test_tiny.py | 3 | main |" in text
    row = [x for x in text.splitlines() if x.startswith(f"| {twice[0]} |")]
    assert len(row) == 1 and "| 2 | 2 | test_tiny.py |" in row[0]
