"""pp through the port's entry points on the CPU:

* ``tfrun --mesh pp=2`` over ``transformer_train --pp-schedule 1f1b``,
  its losses one process's (float32, atol and rtol 1e-5: the same
  gradients, summed in another order);
* the dry run's pp factorizations over 8 gloo ranks (JAX's
  ``__graft_entry__.dryrun_multichip`` ones), each held to one process
  within the module's 1e-5.
"""

import json
import re
import sys

import numpy as np
import pytest


def test_tfrun_trains_pp_on_1f1b_as_one_process(capfd, tmp_path):
    """``tfrun -w 2 --mesh pp=2`` over ``transformer_train --tiny
    --pp-schedule 1f1b`` on the CPU: both stages print the same losses,
    one process's (the same stream, the same gradients); with
    ``--grads-out`` the first step's gradients gathered whole equal one
    process's, and ``--time-collectives`` prints each rank's ms a step
    in collectives, ``params held`` its share."""
    from tfmesos_tpu_torch import transformer_train
    from tfmesos_tpu_torch.cli import run_main

    argv = ["--tiny", "--steps", "2", "--device", "cpu", "--batch_size",
            "4", "--seq_len", "32"]
    rc = run_main(["-w", "2", "-s", "0", "--mesh", "pp=2", "--worker-logs",
                   "*", "--", sys.executable, "-m",
                   "tfmesos_tpu_torch.transformer_train", *argv,
                   "--pp-schedule", "1f1b", "--grads-out",
                   str(tmp_path / "pp.npz"), "--time-collectives"])
    assert rc == 0
    out = capfd.readouterr().out
    assert "mesh={'pp': 2}" in out
    losses = dict(re.findall(r"^\[worker:\d\] rank (\d)/2 step losses: "
                             r"(\[.*\])$", out, re.M))
    assert sorted(losses) == ["0", "1"] and losses["0"] == losses["1"]
    held = re.findall(r"^\[worker:\d\] rank \d/2 params held: (\d+) of "
                      r"(\d+)$", out, re.M)
    assert len(held) == 2 and all(int(a) < int(b) for a, b in held)
    assert len(re.findall(r"^\[worker:\d\] rank \d/2 collectives: "
                          r"[\d.]+ ms a step of [\d.]+$", out, re.M)) == 2
    assert transformer_train.main(argv + ["--grads-out",
                                          str(tmp_path / "one.npz")]) == 0
    one = re.search(r"^rank 0/1 step losses: (\[.*\])$",
                    capfd.readouterr().out, re.M).group(1)
    np.testing.assert_allclose(json.loads(losses["0"]), json.loads(one),
                               atol=1e-5, rtol=1e-5)
    got, want = np.load(tmp_path / "pp.npz"), np.load(tmp_path / "one.npz")
    assert sorted(got) == sorted(want) and "layers/wq" in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("axes", [{"pp": 2, "tp": 2, "dp": 2},
                                  {"pp": 2, "ep": 2, "dp": 2},
                                  {"pp": 2, "tp": 2, "ep": 2, "dp": 1}])
def test_dryrun_multichip_pp_factorizations(axes):
    """JAX's pp factorizations of the dry run over 8 gloo ranks: one
    training step held to one process within the module's bound, the
    MoE router's gradient non-zero."""
    from tfmesos_tpu_torch.dryrun import TOL, dryrun_multichip, \
        factorizations

    assert axes in factorizations(8)
    out = dryrun_multichip(8, timeout=200.0, axes=axes)
    assert abs(out["loss"] - out["ref_loss"]) <= TOL
    assert out["grad_err"] <= TOL and out["param_err"] <= TOL
    if "ep" in axes:
        assert out["router_grad"] > 0
