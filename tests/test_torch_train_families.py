"""Families from training, the port against the JAX package on the CPU:
``repro_torch/diffusion/train.py``'s trajectory fine-tune and
``get_or_train_families``, and where they run.

* The teacher pool (the large net's own edge-ladder trajectory) on the
  reference's ``xT`` within ``POOL_RTOL`` of the reference's ``traj`` for
  both families (DDIM for XL, the interior step for F3); then the F3
  fine-tune (``finetune_from``, what ``finetune_on_trajectories`` runs)
  against the reference's ``finetune_on_trajectories`` for a few steps on
  the same ``default_rng(0)`` picks: the student within ``TUNE_RTOL``.
* ``get_or_train_families`` with ``with_mid=True`` and tiny steps into a
  temporary directory: the four files written; the JAX package's
  ``checkpoint.restore`` and ``make_family`` read them, and its samplers
  on them give the port's latents within ``SAMPLE_RTOL``; the port's
  ``load_families`` reads back the trained modules bit for bit; a second
  call loads and trains nothing.  The seeds and the fine-tune's branch
  (``steps >= 300``, ``min(350, steps)`` steps) as the reference's.
  The reference's own training cases are ``tests/test_torch_train_cases.py``.
* Where it runs: the entry points default to the card and raise without
  CUDA; ``Executor``, ``train_model``, ``finetune_on_trajectories`` and
  ``get_or_train_families`` each turn TF32 off (``device.keep_fp32``).
"""
from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import samplers as jsamplers
from repro.diffusion import families as jfam
from repro.diffusion import train as jt
from repro.models import diffusion_nets as jdn
from repro.training import checkpoint as jck
from repro.training.checkpoint import _flatten
from repro_torch.core import samplers as tsamplers
from repro_torch.diffusion import families as tfam
from repro_torch.diffusion import synth
from repro_torch.diffusion import train as tt
from repro_torch.serving import executor as texec
from repro_torch.training import checkpoint as tck

torch.set_num_threads(1)

CKPTS = Path(__file__).resolve().parents[1] / "results" / "ckpts"
# the teacher pool, 8 trajectories of the trained large nets, max |Δ| over
# max |reference| of the whole pool: read 4.2e-7 (XL), 3.3e-7 (F3)
POOL_RTOL = 1e-5
# the F3 student after 3 fine-tune steps (batch 16) from the trained small
# net, per tensor: read 4.3e-6
TUNE_RTOL = 1e-5
# the reference's samplers (10 steps) on the port's files against the
# port's, every role of both families: read 3.0e-7
SAMPLE_RTOL = 1e-5


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def reference_family(ckpt_dir, fam, with_mid=False):
    """The reference family from ``ckpt_dir``, read by the JAX package's
    own checkpoint code."""
    def like(role):
        return jax.eval_shape(lambda: jdn.init_net(
            jax.random.PRNGKey(0), jfam.NET_CONFIGS[(fam, role)]))

    pair, _ = jck.restore(Path(ckpt_dir) / f"diffusion_{fam}.ckpt",
                          {"large": like("large"), "small": like("small")})
    mid = None
    if with_mid:
        mid = jck.restore(Path(ckpt_dir) / f"diffusion_{fam}_mid.ckpt",
                          {"mid": like("mid")})[0]["mid"]
    return jfam.make_family(fam, pair["large"], pair["small"], mid_params=mid)


@pytest.fixture(scope="module")
def trained():
    return ({f: reference_family(CKPTS, f) for f in ("XL", "F3")},
            tfam.load_families(CKPTS, device="cpu"))


def _xT(key, n):
    """The reference fine-tune's initial latents (``k1`` of its key)."""
    k1, _ = jax.random.split(key)
    return jax.random.normal(k1, (n, 8, 8, 4))


@pytest.mark.parametrize("fam", ["XL", "F3"])
def test_teacher_pool_matches_reference(trained, fam):
    ref_fams, port_fams = trained
    n = 8
    xT = _xT(jax.random.PRNGKey(200), n)
    _, _, cond = synth.batch(np.arange(500_000, 500_000 + n), fam)
    spec = ref_fams[fam].spec
    sampler = (jsamplers.rf_euler_sample if spec.kind == "rf"
               else jsamplers.ddim_sample)
    _, traj = sampler(ref_fams[fam].large_fn, ref_fams[fam].large_params, xT,
                      spec.sigmas_edge, jnp.asarray(cond))
    states, levels = tt.teacher_pool(fam, port_fams[fam].large_params,
                                     torch.from_numpy(np.array(xT)),
                                     torch.from_numpy(cond))
    assert states.shape == (49, n, 8, 8, 4)
    assert _rel(states, traj[:-1]) <= POOL_RTOL
    np.testing.assert_array_equal(levels.numpy(),
                                  np.asarray(spec.sigmas_edge)[1:-1])


def test_finetune_matches_reference(trained):
    ref_fams, port_fams = trained
    key, steps, n, batch = jax.random.PRNGKey(201), 3, 8, 16
    ref = jt.finetune_on_trajectories(
        key, "F3", ref_fams["F3"].large_params, ref_fams["F3"].small_params,
        steps=steps, n_traj=n, batch=batch)
    small = port_fams["F3"].small_params
    before = {k: v.clone() for k, v in small.state_dict().items()}
    got = tt.finetune_from("F3", port_fams["F3"].large_params, small,
                           torch.from_numpy(np.array(_xT(key, n))),
                           steps=steps, batch=batch)
    # the served family keeps its weights; the tuned copy is frozen
    assert all(torch.equal(v, small.state_dict()[k]) for k, v in before.items())
    assert not any(p.requires_grad for p in got.parameters())
    cfg = tfam.NET_CONFIGS[("F3", "small")]
    flat, want = tck.params_to_jax(got.state_dict(), cfg), _flatten(ref)
    assert list(flat) == list(want)
    assert max(_rel(flat[k], want[k]) for k in want if want[k].any()) \
        <= TUNE_RTOL


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Families trained by the port (2 steps of batch 4, mid stages too)
    into a fresh directory."""
    out = tmp_path_factory.mktemp("ckpts")
    fams = tt.get_or_train_families(out, steps=2, batch=4, with_mid=True,
                                    device="cpu")
    return out, fams


def test_written_files_read_by_reference(written):
    out, fams = written
    assert sorted(p.name for p in out.iterdir()) == [
        "diffusion_F3.ckpt", "diffusion_F3_mid.ckpt", "diffusion_XL.ckpt",
        "diffusion_XL_mid.ckpt"]
    rng = np.random.default_rng(3)
    worst = 0.0
    for fam in ("XL", "F3"):
        ref = reference_family(out, fam, with_mid=True)
        port = fams[fam]
        spec = port.spec
        xT = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
        _, _, cond = synth.batch(np.arange(2), fam)
        jsample = (jsamplers.rf_euler_sample if spec.kind == "rf"
                   else jsamplers.ddim_sample)
        for role in ("large", "mid", "small"):
            want, _ = jsample(getattr(ref, f"{role}_fn"),
                              getattr(ref, f"{role}_params"),
                              jnp.asarray(xT), ref.spec.sigmas_edge,
                              jnp.asarray(cond), stop=10, capture_traj=False)
            with torch.no_grad():
                got, _ = tsamplers.sampler_for(spec.kind)(
                    tfam.role_fn(port, role), tfam.role_params(port, role),
                    torch.from_numpy(xT), spec.sigmas_edge,
                    torch.from_numpy(cond), stop=10, capture_traj=False)
            worst = max(worst, _rel(got, want))
    assert worst <= SAMPLE_RTOL, worst


def test_written_files_load_back_bit_for_bit(written, monkeypatch):
    out, fams = written
    loaded = tfam.load_families(out, with_mid=True, device="cpu")
    for fam in ("XL", "F3"):
        for role in ("large", "mid", "small"):
            a = tfam.role_params(fams[fam], role).state_dict()
            b = tfam.role_params(loaded[fam], role).state_dict()
            assert a.keys() == b.keys()
            assert all(torch.equal(a[k], b[k]) for k in a), (fam, role)

    def no_training(*args, **kw):
        raise AssertionError("a cached family was trained again")

    monkeypatch.setattr(tt, "train_model", no_training)
    monkeypatch.setattr(tt, "train_family_pair", no_training)
    again = tt.get_or_train_families(out, steps=2, batch=4, with_mid=True,
                                     device="cpu")
    for fam in ("XL", "F3"):
        a = again[fam].mid_params.state_dict()
        b = loaded[fam].mid_params.state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("steps,tuned", [(299, None), (300, 300),
                                         (400, 350)])
def test_seeds_and_finetune_branch(tmp_path, monkeypatch, steps, tuned):
    """The reference's seeds (pair 100 + i, fine-tune 200 + i, mid 300 +
    i) and its branch: a fine-tune of min(350, steps) steps when steps >=
    300 (``train.py:284``)."""
    calls = []

    def pair(seed, fam, *, steps_large, steps_small, batch, verbose, device):
        calls.append(("pair", seed, fam, steps_large, steps_small))
        large = tt._frozen(tt.dn.init_net(tt.NET_CONFIGS[(fam, "large")],
                                          torch.Generator()))
        small = tt._frozen(tt.dn.init_net(tt.NET_CONFIGS[(fam, "small")],
                                          torch.Generator()))
        return large, small, {}

    def tune(seed, fam, large, small, *, steps, verbose, device):
        calls.append(("tune", seed, fam, steps))
        return small

    def model(seed, fam, size, *, steps, batch, teacher, verbose, device):
        calls.append(("mid", seed, fam, steps))
        return tt._frozen(tt.dn.init_net(tt.NET_CONFIGS[(fam, size)],
                                         torch.Generator())), []

    monkeypatch.setattr(tt, "train_family_pair", pair)
    monkeypatch.setattr(tt, "finetune_on_trajectories", tune)
    monkeypatch.setattr(tt, "train_model", model)
    tt.get_or_train_families(tmp_path, steps=steps, with_mid=True,
                             device="cpu")
    want = []
    for i, fam in enumerate(("XL", "F3")):
        want.append(("pair", 100 + i, fam, steps, steps))
        if tuned:
            want.append(("tune", 200 + i, fam, tuned))
        want.append(("mid", 300 + i, fam, steps))
    assert calls == want


def test_entry_points_need_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("the default device is present")
    large = tfam.load_families(CKPTS, device="cpu")["XL"].large_params
    calls = [lambda: tt.train_model(0, "XL", "small", steps=1, batch=2),
             lambda: tt.train_family_pair(0, "XL", steps_large=1,
                                          steps_small=1, batch=2),
             lambda: tt.finetune_on_trajectories(0, "XL", large, large,
                                                 steps=1),
             lambda: tt.get_or_train_families("unused", steps=1)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_entry_points_turn_tf32_off(monkeypatch):
    """``device.keep_fp32`` is called by the executor, ``train_model``,
    the fine-tune and ``get_or_train_families`` with their device."""
    seen = []
    count = lambda dev: seen.append(torch.device(dev).type)
    for mod in (texec, tt):
        monkeypatch.setattr(mod, "keep_fp32", count)
    fams = tfam.load_families(CKPTS, device="cpu")
    texec.Executor(fams, device="cpu")
    assert seen == ["cpu"]
    tt.train_model(0, "XL", "small", steps=1, batch=2, device="cpu")
    assert seen == ["cpu"] * 2
    tt.finetune_on_trajectories(0, "F3", fams["F3"].large_params,
                                fams["F3"].small_params, steps=1, n_traj=2,
                                batch=2, device="cpu")
    assert seen == ["cpu"] * 3
    tt.get_or_train_families(CKPTS, families=("XL",), device="cpu")
    assert seen == ["cpu"] * 4
