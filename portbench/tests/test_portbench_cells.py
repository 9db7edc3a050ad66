"""Each cell run on the CPU at a tiny size, the look for a card skipped:
a sound run comes out correct; the control (the reference in TF32 in the
program's place) and each fault that the cell can have, planted in the
timed path, come out not correct. The fault of an exchange between chips
left out does not apply: every cell runs on one card."""

import time

import pytest
import torch

from portbench.harness import cell
from portbench.tests.conftest import tiny_run

SEED = 2 ** 31 + 12345  # beyond 32 signed bits


def _run(name, trace=False):
    run = tiny_run(name, SEED, trace=trace)
    cell.execute(run, time.perf_counter())
    return run, cell.result(run)


@pytest.mark.parametrize("name", ["c4_fit", "c5_fit", "c4_serve"])
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(name, trace):
    run, out = _run(name, trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    if not trace:
        assert "setup_s" in out["metrics"]
    else:
        assert out["device"]["window_s"] > 0


@pytest.mark.parametrize("name", ["c4_fit", "c5_fit", "c4_serve"])
def test_control_is_not_correct(name):
    run = tiny_run(name, SEED)
    state = cell.execute(run, time.perf_counter())
    numbers = cell.driver(run).control(run, state)
    assert any(not (numbers[k] <= run.limit(k)) for k in
               run.workload["limits"] if k in numbers), numbers


# --- faults planted in the timed path --------------------------------------

def _no_steps(monkeypatch):
    """A step that returns its state unchanged: the optimizers take none."""
    from madaiemulator_tpu_torch.models import fit, lbfgs

    host, lock = fit.fit_gp_host, lbfgs.run_lbfgs
    monkeypatch.setattr(fit, "fit_gp_host",
                        lambda *a, **k: host(*a, **{**k, "max_steps": 0}))
    monkeypatch.setattr(lbfgs, "run_lbfgs",
                        lambda u0, vg, v, steps, **k: lock(u0, vg, v, 0, **k))


def _half_lanes(monkeypatch):
    """Half of the batch left out: the second half of the lanes get the
    first half's log-likelihoods."""
    from madaiemulator_tpu_torch.models import gp

    orig = gp.log_marginal_likelihood

    def lml(params, data, config):
        ll = orig(params, data, config)
        if ll.ndim == 0 or ll.shape[0] < 2:
            return ll
        h = ll.shape[0] // 2
        return torch.cat([ll[:ll.shape[0] - h], ll[:h]])

    monkeypatch.setattr(gp, "log_marginal_likelihood", lml)
    from madaiemulator_tpu_torch.models import fit
    monkeypatch.setattr(fit, "log_marginal_likelihood", lml)


def _altered_fit_answer(monkeypatch):
    """An answer altered where it is produced: the fit's log-likelihoods
    moved by 5% of their size."""
    from madaiemulator_tpu_torch.models import fit
    from madaiemulator_tpu_torch.parallel import ensemble

    for mod, name in ((fit, "fit_gp_host"), (ensemble, "fit_ensemble")):
        orig = getattr(mod, name)

        def wrapped(*a, _orig=orig, **k):
            res = _orig(*a, **k)
            ll = res.restart_log_likelihoods
            return res._replace(restart_log_likelihoods=ll + 0.05 * ll.abs())

        monkeypatch.setattr(mod, name, wrapped)


def _half_points(monkeypatch):
    """Half of the batch left out: the second half of a request's points
    get the first half's answers."""
    from madaiemulator_tpu_torch.models import gp

    orig = gp.predict_from_precomputed

    def predict(*a, **k):
        mean, var = orig(*a, **k)
        h = mean.shape[-1] // 2
        if h == 0:
            return mean, var
        m = mean.shape[-1]
        pick = torch.cat([torch.arange(m - h), torch.arange(h)])
        return mean[..., pick], var[..., pick]

    monkeypatch.setattr(gp, "predict_from_precomputed", predict)


def _altered_point(monkeypatch):
    """An answer altered where it is produced: one mean moved by 1% of the
    targets' spread."""
    from madaiemulator_tpu_torch.models import gp

    orig = gp.predict_from_precomputed

    def predict(state, params, data, Xs, config, **k):
        mean, var = orig(state, params, data, Xs, config, **k)
        mean = mean.clone()
        mean[..., 0] += 0.01 * float(data.y.std())
        return mean, var

    monkeypatch.setattr(gp, "predict_from_precomputed", predict)


FAULTS = [("c4_fit", _no_steps), ("c5_fit", _no_steps),
          ("c4_fit", _half_lanes), ("c5_fit", _half_lanes),
          ("c4_fit", _altered_fit_answer), ("c5_fit", _altered_fit_answer),
          ("c4_serve", _half_points), ("c4_serve", _altered_point)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__.strip('_')}" for n, f in FAULTS])
def test_fault_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    _, out = _run(name)
    assert not out["correct"], out["checks"]
