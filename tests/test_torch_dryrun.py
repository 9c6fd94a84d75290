"""The port's dry runs (``graft_entry_torch.py``) on the CPU, each on gloo
ranks started as subprocesses that import only the port.

``dryrun_multichip(4)``: poisson3d(64) with the flagship parameters, once
from the global setup and once from the process-local blocked pipeline,
held to the JAX package's record (``MULTICHIP_r05.json``: 12 iterations,
relres 4.33e-10, levels DistDia / DistEll / dense / dense) within one
iteration.  ``dryrun_multiprocess(2)``: the process-local solve of
``parallel/multihost.py`` at 24^3."""
import json
import pathlib

import pytest
import torch

import graft_entry_torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_dryrun_multichip_four_ranks(capsys):
    ref = json.loads((ROOT / "MULTICHIP_r05.json").read_text())
    assert "iters=12" in ref["tail"] and "relres=4.33e-10" in ref["tail"]
    ranks = graft_entry_torch.dryrun_multichip(4, device="cpu", threads=1,
                                               timeout=240)
    printed = capsys.readouterr().out
    assert "blocked-provenance: holds_global_fine=False" in printed
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    for r in ranks:
        assert (r["ranks"], r["backend"], r["device"]) == (4, "gloo", "cpu")
        for key in ("global", "blocked"):
            run = r[key]
            assert abs(run["iterations"] - 12) <= 1, run
            assert run["passes"] == 2 and run["converged"], run
            assert run["relres_host_fp64"] <= 1e-8, run
            assert run["kinds"] == ["DistLevel", "DistLevel", "DeviceLevel",
                                    "DeviceLevel"], run
            assert run["ops"] == ["DistDia", "DistEll", "DenseMatrix",
                                  "DenseMatrix"], run
            assert run["replicated"] and run["gather_out"], run
        assert not r["blocked"]["holds_global_fine"]


def test_dryrun_multiprocess_two_ranks(capsys):
    res = graft_entry_torch.dryrun_multiprocess(2, device="cpu", threads=1)
    assert "process-local setup" in capsys.readouterr().out
    assert [r["process_id"] for r in res] == [0, 1]
    assert all(r["setup"] == "blocked" and r["passes"] == 2 for r in res)
