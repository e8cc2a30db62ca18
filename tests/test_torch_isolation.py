"""The port stands alone: neither `dask_sql_tpu_torch` nor its scripts for
the card (`chip_smoke.py`, `profile_q1.py`) import JAX or the JAX package,
and the port's entry points refuse to run on the CPU unless asked to."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _run(code: str, **env):
    full_env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    full_env.update(env)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=full_env,
                          capture_output=True, text=True, timeout=120)


IMPORT_ALL = """
import importlib, pkgutil, sys
import dask_sql_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dask_sql_tpu_torch.__path__,
                                               "dask_sql_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke, profile_q1
# what the Q3 path imports as it runs (DPP's executor at plan time, the
# join pipeline, the eager join) stays in the port too
from tests.tpch import QUERIES, generate
c = dask_sql_tpu_torch.Context(device="cpu")
tables = generate(400)
for t in ("customer", "orders", "lineitem"):
    c.create_table(t, tables[t])
c.sql(QUERIES[3]).compute()
# repeated build keys: the pipeline declines and the eager join runs
c.sql("SELECT COUNT(*) AS n FROM orders a JOIN orders b "
      "ON a.o_custkey = b.o_custkey").compute()
assert c.metrics["compiled_join.run"] == 1, dict(c.metrics)
assert c.metrics["compiled_join.declined"] == 1, dict(c.metrics)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "dask_sql_tpu"))
assert not bad, bad
print(len(names))
"""


def test_port_and_chip_smoke_import_no_jax():
    out = _run(IMPORT_ALL)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 33  # every module of the port imported


def test_context_defaults_to_the_card(monkeypatch):
    from dask_sql_tpu_torch import Context

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Context()
    assert Context(device="cpu").device == torch.device("cpu")


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
