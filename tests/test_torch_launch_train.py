"""The port's LM training driver (``repro_torch.launch.train``) and its
checkpoints against the JAX package on the CPU.

* A step-4 checkpoint written by ``repro.launch.train`` (reduced
  ``stablelm-1.6b``, batch 2, 16 tokens, the reference's resume test) and
  resumed by the port to step 8 gives the JAX run's uninterrupted losses
  of steps 5-8 within 1e-5 relative (both compute in fp32 and differ in
  the last bits of their sums); the port's step-8 file holds the JAX
  run's step-8 state: the step count exactly, each parameter within
  ``PARAM_SPACINGS`` fp32 spacings of its tensor's largest |p| and each
  moment within ``MOMENT_SPACINGS`` of its tensor's largest (see below).
* The other way: a port-written step-4 file restores in
  ``repro.training.checkpoint.restore`` bit for bit, and the JAX driver
  resumes it to the port's own losses within 1e-5.
* Written from the same tree, the two packages' files are equal byte for
  byte, for fp32, bf16 and log8 optimizer states.
"""
from __future__ import annotations

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import make_reduced as jmake_reduced
from repro.launch import train as jlt
from repro.models import transformer as jtr
from repro.training import checkpoint as jck
from repro.training import optimizer as jopt
from repro_torch import configs
from repro_torch.launch import train as lt
from repro_torch.models import transformer as tr
from repro_torch.training import checkpoint as ck
from repro_torch.training import optimizer as opt

torch.set_num_threads(1)

ARCH = "stablelm-1.6b"
ARGS = ["--arch", ARCH, "--batch", "2", "--seq", "16", "--ckpt-every", "4"]
LOSS_RTOL = 1e-5
# the state after four steps in each package from the same step-4 state:
# each step holds the parameters within 4 spacings and the moments within
# 8 (tests/test_torch_lm_train.py's ADAM_SPACINGS, MOMENT_SPACINGS), and
# the errors of the four add up (read 4 and 11.5).  Both bounds are far
# under one step's update (lr 1e-4 at step 8; 5e-7 at most here)
PARAM_SPACINGS, MOMENT_SPACINGS = 16, 32


def _within(mine, theirs, spacings):
    """Each leaf of ``mine`` within ``spacings`` fp32 spacings of the
    largest |x| of its leaf in ``theirs``."""
    paths = jax.tree_util.tree_leaves_with_path(theirs)
    for (path, b), a in zip(paths, jax.tree.leaves(mine)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        tol = spacings * np.spacing(np.float32(np.abs(b).max()))
        assert a.shape == b.shape and (np.abs(a - b) <= tol).all(), (
            jax.tree_util.keystr(path), float(np.abs(a - b).max() / tol))


def _jax_like(name="stablelm-1.6b", state_dtype="fp32"):
    cfg = jmake_reduced(jconfigs.get_config(name))
    params = jtr.init_model(jax.random.PRNGKey(0), cfg)
    return params, jopt.adamw_init(params, jopt.OptConfig(
        state_dtype=state_dtype))


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX driver: 8 steps uninterrupted, and 4 steps into another
    directory (its step-4 checkpoint)."""
    root = tmp_path_factory.mktemp("jax")
    full = jlt.main(ARGS + ["--steps", "8", "--ckpt-dir", str(root / "a")])
    jlt.main(ARGS + ["--steps", "4", "--ckpt-dir", str(root / "b")])
    return root, full


def test_port_resumes_a_jax_checkpoint(jax_runs, tmp_path):
    root, full = jax_runs
    shutil.copytree(root / "b", tmp_path / "b", symlinks=True)
    losses = lt.main(ARGS + ["--steps", "8", "--resume", "--device", "cpu",
                             "--ckpt-dir", str(tmp_path / "b")])
    assert len(losses) == 4
    np.testing.assert_allclose(losses, full[4:], rtol=LOSS_RTOL)
    like = _jax_like()
    mine, meta = jck.restore(tmp_path / "b" / ARCH, like)
    theirs, _ = jck.restore(root / "a" / ARCH / "step_00000008.ckpt", like)
    assert meta == {"step": 8, "arch": ARCH}
    assert int(mine[1]["count"]) == 8 == int(theirs[1]["count"])
    _within(mine[0], theirs[0], PARAM_SPACINGS)
    for moment in ("m", "v"):
        _within(mine[1][moment], theirs[1][moment], MOMENT_SPACINGS)


def test_jax_resumes_a_port_checkpoint(tmp_path):
    full = lt.main(ARGS + ["--steps", "8", "--device", "cpu",
                           "--ckpt-dir", str(tmp_path / "a")])
    lt.main(ARGS + ["--steps", "4", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path / "b")])
    path = tmp_path / "b" / ARCH
    assert ck.latest_step(path) == 4 == jck.latest_step(path)
    like = _jax_like()
    (params, state), meta = jck.restore(path, like)
    assert meta == {"step": 4, "arch": ARCH}
    flat = ck.load_flat(path / "step_00000004.ckpt")
    ref = jck._flatten((params, state))
    assert list(flat) == list(ref)
    for key, a in ref.items():
        assert a.dtype == flat[key].dtype and np.array_equal(a, flat[key])
    losses = jlt.main(ARGS + ["--steps", "8", "--resume",
                              "--ckpt-dir", str(tmp_path / "b")])
    np.testing.assert_allclose(losses, full[4:], rtol=LOSS_RTOL)


def test_port_resume_is_bit_exact(tmp_path):
    """The reference's ``test_train_resume_bitexact`` on the port."""
    full = lt.main(ARGS + ["--steps", "8", "--device", "cpu",
                           "--ckpt-dir", str(tmp_path / "a")])
    lt.main(ARGS + ["--steps", "4", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path / "b")])
    resumed = lt.main(ARGS + ["--steps", "8", "--device", "cpu", "--resume",
                              "--ckpt-dir", str(tmp_path / "b")])
    assert resumed == full[4:]
    assert sorted(p.name for p in (tmp_path / "b" / ARCH).iterdir()) == [
        "latest", "step_00000004.ckpt", "step_00000008.ckpt"]


@pytest.mark.parametrize("name", ["qwen3-4b", "recurrentgemma-9b",
                                  "stablelm-1.6b"])
@pytest.mark.parametrize("state_dtype", ["fp32", "bf16", "int8"])
def test_checkpoint_bytes_equal_the_reference(name, state_dtype, tmp_path):
    """The reference's init, carried across, with its zero AdamW state:
    the same keys (blocks stacked, remainder under ``rem``, ``q``/``s``
    for log8 moments), dtypes and bytes; and the port reads the file back
    into a model and state equal to what it wrote."""
    params, state = _jax_like(name, state_dtype)
    cfg = configs.make_reduced(configs.get_config(name))
    model = tr.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    model.load_state_dict(ck.lm_params_from_jax(
        jax.tree.map(np.asarray, params), cfg))
    pstate = opt.adamw_init(dict(model.named_parameters()),
                            opt.OptConfig(state_dtype=state_dtype))
    meta = {"step": 3, "arch": name}
    ref = jck.save(tmp_path / "j", (params, state), step=3, meta=meta)
    flat = ck.lm_state_to_jax(model, pstate, cfg)
    got = ck.save(tmp_path / "p", flat, meta, step=3)
    assert got.read_bytes() == ref.read_bytes()
    assert (tmp_path / "p" / "latest").resolve() == got.resolve()

    other = tr.init_model(cfg, torch.Generator().manual_seed(1), "cpu")
    back, meta2 = ck.restore(tmp_path / "p", flat)
    assert meta2 == meta
    st2 = ck.lm_state_from_jax(back, other, cfg)
    for (n, a), b in zip(model.named_parameters(), other.parameters()):
        assert torch.equal(a, b), n
    again = ck.lm_state_to_jax(other, st2, cfg)
    assert list(again) == list(flat)
    for key in flat:
        assert flat[key].dtype == again[key].dtype
        assert torch.equal(flat[key], again[key]), key


def test_lm_tree_round_trip_keeps_every_leaf():
    """Unstacking then stacking again gives the reference's tree back,
    int8 moments (``{"q", "s"}`` leaves) included."""
    params, state = _jax_like("recurrentgemma-9b", "int8")
    cfg = configs.make_reduced(configs.get_config("recurrentgemma-9b"))
    for tree in (params["lm"], state["m"]["lm"]):
        tree = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)
        named = ck.lm_tree_from_jax(tree, cfg)
        assert "layers.4.rglru.lam" in named and "layers.2.attn.wq" in named
        back = ck.flatten(ck.lm_tree_to_jax(named, cfg))
        ref = ck.flatten(tree)
        assert list(back) == list(ref)
        assert all(torch.equal(back[k], ref[k]) for k in ref)


def test_checkpoint_roundtrip(tmp_path):
    """The reference's ``test_checkpoint_roundtrip`` on the port."""
    tree = {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "nested": {"b": torch.ones(2, dtype=torch.bfloat16)},
        "q": {"q": torch.ones(2, 2, dtype=torch.int8), "s": torch.ones(2, 1)},
    }
    flat = ck.flatten(tree)
    assert list(flat) == ["a", "nested/b", "q/q", "q/s"]
    p = ck.save(tmp_path / "t.ckpt", flat, {"step": 7})
    restored, meta = ck.restore(p, flat)
    assert meta["step"] == 7
    for k, v in flat.items():
        assert restored[k].dtype == v.dtype and torch.equal(restored[k], v)
    assert ck.unflatten(restored)["q"]["q"].dtype == torch.int8
    # the JAX package reads the same file
    jflat = jck._flatten(jck.restore(p, {
        "a": jnp.zeros((3, 4)), "nested": {"b": jnp.zeros(2, jnp.bfloat16)},
        "q": {"q": jnp.zeros((2, 2), jnp.int8), "s": jnp.zeros((2, 1))}})[0])
    for k, v in flat.items():
        np.testing.assert_array_equal(np.asarray(jflat[k], np.float32),
                                      v.float().numpy())


def test_checkpoint_latest_and_versions(tmp_path):
    flat = {"w": torch.zeros(2)}
    for s in (10, 20, 30):
        ck.save(tmp_path, flat, {"step": s}, step=s)
    assert ck.latest_step(tmp_path) == 30
    _, meta = ck.restore(tmp_path, flat)  # follows `latest`
    assert meta["step"] == 30
    assert ck.latest_step(tmp_path / "absent") is None


def test_checkpoint_mismatches_raise(tmp_path):
    p = ck.save(tmp_path / "t.ckpt", {"w": torch.zeros(2, 2)})
    with pytest.raises(ValueError):
        ck.restore(p, {"w": torch.zeros(3, 3)})
    with pytest.raises(KeyError, match="missing"):
        ck.restore(p, {"v": torch.zeros(2, 2)})


def test_checkpoint_async_snapshots_before_returning(tmp_path):
    w = torch.ones(4)
    t = ck.save_async(tmp_path, {"w": w}, {"step": 1}, step=1)
    w.add_(1.0)  # a later in-place update does not reach the file
    t.join(timeout=30)
    assert not t.is_alive() and ck.latest_step(tmp_path) == 1
    back, _ = ck.restore(tmp_path, {"w": w})
    assert torch.equal(back["w"], torch.ones(4))


def test_driver_turns_tf32_off_and_needs_cuda_unless_told_cpu(monkeypatch,
                                                              tmp_path):
    from repro_torch import device

    seen = []
    monkeypatch.setattr(device, "keep_fp32", lambda d: seen.append(str(d)))
    lt.main(ARGS + ["--steps", "1", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path)])
    assert seen == ["cpu"]
    if torch.cuda.is_available():
        pytest.skip("checks the default device where CUDA is absent")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lt.main(ARGS + ["--steps", "1", "--ckpt-dir", str(tmp_path)])
