"""The port's checkpoint reader and writer and its denoisers against the
reference: the built-in msgpack decoder against the ``msgpack`` package on
every committed checkpoint; the writer (``checkpoint.save``) rewriting
every committed checkpoint byte for byte from what the reader gives, and
``params_to_jax`` inverting ``params_from_jax`` in keys, order and bytes
for all six nets; and all six (family, role) nets with the trained
weights against the JAX nets on the same numpy inputs.

Tolerance: fp32 relative error (max |Δ| over max |reference|) ≤ 1e-5.
Both sides run fp32 on the CPU; they differ only in the order of sums
inside convolutions and matrix products and in ``exp``/``tanh`` last bits:
the worst of the six nets measured 2.0e-6 (F3 small).
"""
from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.diffusion import families as jfam
from repro.models import diffusion_nets as jdn
from repro.training import checkpoint as jck
from repro_torch.diffusion import families as tfam
from repro_torch.diffusion import synth
from repro_torch.training import checkpoint as tck

# tiny tensors: one thread each, or the parallel test workers oversubscribe
# the cores many times over
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CKPTS = sorted(REPO.glob("results/ckpts*/diffusion_*.ckpt"))
NETS = [("XL", "large"), ("XL", "small"), ("XL", "mid"),
        ("F3", "large"), ("F3", "small"), ("F3", "mid")]


def reference_params(fam, role):
    """One net's reference weights, read by the JAX package's own
    checkpoint code."""
    like = jax.eval_shape(lambda: jdn.init_net(jax.random.PRNGKey(0),
                                               jfam.NET_CONFIGS[(fam, role)]))
    name = f"diffusion_{fam}_mid.ckpt" if role == "mid" else f"diffusion_{fam}.ckpt"
    return jck.restore(REPO / "results" / "ckpts" / name, {role: like})[0][role]


def net_flat(fam, role):
    name = f"diffusion_{fam}_mid.ckpt" if role == "mid" else f"diffusion_{fam}.ckpt"
    return tck.subtree(tck.load_flat(REPO / "results" / "ckpts" / name), role)


def _inputs(fam, n=3):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(n, 8, 8, 4)).astype(np.float32)
    _, _, cond = synth.batch(np.arange(n), fam)
    return x, cond.astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("path", CKPTS, ids=lambda p: f"{p.parent.name}/{p.name}")
def test_msgpack_decoder_matches_msgpack(path):
    data = path.read_bytes()
    assert tck.unpackb(data) == msgpack.unpackb(data)


def test_decoder_scalars_and_errors():
    doc = {"a": [0, 127, 128, 65536, 2 ** 40, -1, -33, -2 ** 20, None],
           "b": b"\x00" * 300, "s" * 40: "x" * 70000}
    assert tck.unpackb(msgpack.packb(doc)) == doc
    with pytest.raises(ValueError, match="trailing"):
        tck.unpackb(msgpack.packb(1) + b"\x00")
    with pytest.raises(ValueError, match="unsupported"):
        tck.unpackb(b"\xca\x00\x00\x00\x00")  # a float: not in the files


@pytest.mark.parametrize("path", CKPTS, ids=lambda p: f"{p.parent.name}/{p.name}")
def test_save_rewrites_checkpoint_byte_for_byte(path, tmp_path):
    out = tck.save(tmp_path / "sub" / path.name, tck.load_flat(path))
    assert out.read_bytes() == path.read_bytes()
    assert sorted(p.name for p in out.parent.iterdir()) == [path.name]


def test_encoder_matches_msgpack():
    doc = {"a": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 40, -1, -32, -33,
                 -128, -129, -2 ** 20, -2 ** 40, None],
           "b": b"\x00" * 300, "c": b"", "d": b"\x01" * 70000,
           "s" * 40: "x" * 70000, "e": {}, "f": [[]] * 20,
           "g": {str(i): i for i in range(20)}}
    assert tck.packb(doc) == msgpack.packb(doc)
    assert tck.unpackb(tck.packb(doc)) == doc
    for bad in (True, 1.5, {1, 2}):
        with pytest.raises(TypeError):
            tck.packb(bad)


@pytest.mark.parametrize("fam,role", NETS)
def test_params_to_jax_inverts_params_from_jax(fam, role):
    cfg = tfam.NET_CONFIGS[(fam, role)]
    flat = net_flat(fam, role)
    back = tck.params_to_jax(tck.params_from_jax(flat, cfg), cfg)
    assert list(back) == list(flat)
    for k, a in flat.items():
        assert back[k].dtype == a.dtype and back[k].shape == a.shape, k
        assert back[k].tobytes() == a.tobytes(), k


@pytest.mark.parametrize("fam,role", NETS)
def test_net_matches_reference(fam, role):
    """Trained weights, same inputs: the port's module equals the JAX net,
    and the family's role function (x̂0 → ε̂ or v̂) follows it."""
    cfg = tfam.NET_CONFIGS[(fam, role)]
    flat = net_flat(fam, role)
    net = tfam.load_net(flat, cfg, "cpu")
    params = reference_params(fam, role)
    x, cond = _inputs(fam)
    spec = tfam.SPECS[fam]()
    t = spec.sigmas_edge[12]
    ref = jax.jit(lambda p, x, t, c: jdn.apply_net(p, cfg, x, t, c))(
        params, jnp.asarray(x), jnp.asarray(t.numpy()), jnp.asarray(cond))
    with torch.inference_mode():
        got = net(torch.from_numpy(x), t, torch.from_numpy(cond))
    assert got.shape == x.shape
    assert _rel(got, ref) <= 1e-5
    fam_j = jfam.make_family(fam, params, params, mid_params=params)
    fam_t = tfam.Family(spec, cfg, cfg, net, net, cfg, net)
    for tv in (spec.sigmas_edge[0], spec.sigmas_edge[40]):
        ref = getattr(fam_j, f"{role}_fn")(params, jnp.asarray(x),
                                          jnp.asarray(tv.numpy()),
                                          jnp.asarray(cond))
        with torch.inference_mode():
            got = tfam.role_fn(fam_t, role)(net, torch.from_numpy(x), tv,
                                            torch.from_numpy(cond))
        assert _rel(got, ref) <= 1e-5


def test_params_from_jax_layout():
    flat = net_flat("XL", "small")
    sd = tck.params_from_jax(flat, tfam.NET_CONFIGS[("XL", "small")])
    np.testing.assert_array_equal(sd["stem"].numpy(),
                                  flat["stem"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["emb1"].numpy(), flat["emb1"])
    assert "down.0.conv1" in sd and "down.0.skip" not in sd
    assert "up.0.skip" in sd  # the 2w -> w block has a projection


def test_load_families_raises_on_missing_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError, match="diffusion_XL.ckpt"):
        tfam.load_families(tmp_path, device="cpu")
