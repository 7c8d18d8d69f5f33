"""The port's distributed layer on gloo ranks on the CPU, against the JAX
package and against the port's own unsharded twins.

Each mesh layout of the file is one spawn of eight gloo ranks
(``torch.multiprocessing``) with its own timeout (``SPAWNS``): ``data x
model`` 2x4 and 4x2, ``pod`` 8, ``pod x data`` 4x2, ``stage x data`` 2x4
and 4x2, and the elastic restore's save on 2x4 and load on 4x2.  A spawn
runs when a test first needs it.  The ranks run the port (this module's
``_rank_main``; it imports no JAX, so the children stay light) and rank 0
writes what they computed; the tests hold it against the reference
computed here.

* the expert-parallel MoE (reduced deepseek-v3-671b and llama4 on 2x4
  and 4x2, the reference parity test's inputs: ``init_moe(PRNGKey(0))``,
  ``x`` (4, 16, d) * 0.5) within the reference's own 1e-4 of the JAX
  local ``moe_fwd``, of the port's local path, and of the reference's
  sharded ``moe_fwd`` run in a forced-device subprocess
  (``conftest.run_forced_devices``);
* sharded GQA on a model axis of 4 (``GQA_CASES``): 6 heads with head
  padding (to 8) and without (every head on every rank), and 8 heads
  over 4 KV heads split with them, the forward, every weight's gradient
  and a cached decode against the local ones and the forward against
  the reference's within 1e-5 (fp32);
* one ``make_train_step(mesh=)`` step on 2x4 of reduced qwen3-4b,
  deepseek-v3-671b and llama4 with ZeRO-1 moments: loss, ``grad_norm``,
  every gradient and the updated parameters against the port's and the
  JAX unsharded step over two micro-batches of the two data shards' rows
  (``accum_steps=2``: the sharded loss takes the MoE's aux term per data
  shard, ``pmean``'d, as the reference's sharded MoE does), within
  ``test_torch_lm_train.py``'s tolerances;
* ``make_prefill_step``/``make_serve_step(mesh=)`` on 2x4 (qwen3-4b and
  deepseek-v3-671b, 4 decode steps) against the unsharded steps;
* ``compressed_psum`` on 8 and 4 ranks: the reference parity test's
  checks, and distinct inputs per rank against JAX's
  ``fused_error_feedback_step`` on each rank's input;
* ``pipeline_apply`` on 2 and 4 stages, fp32 and bf16, against the
  sequential JAX layers with the reference's 1e-5 and 3e-2;
* ``checkpoint.restore`` of a save from 2x4 onto 4x2 (the reference's
  ``test_checkpoint_elastic_reshard``).
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

WORLD = 8
SPAWN_TIMEOUT = 240.0  # seconds, for each spawn (one takes 6-25 s alone)
JAX_TIMEOUT = 300.0  # the reference's forced-device sharded MoE
MOE_TOL = 1e-4  # the reference parity test's
GQA_TOL = 1e-5
PIPE_TOL = {"float32": 1e-5, "bfloat16": 3e-2}  # the reference's
SERVE_RTOL = 1e-5
MOE_NAMES = ("deepseek-v3-671b", "llama4-maverick-400b-a17b")
STEP_NAMES = ("qwen3-4b",) + MOE_NAMES
SERVE_NAMES = ("qwen3-4b", "deepseek-v3-671b")
MESHES = {"2x4": (2, 4), "4x2": (4, 2)}
DECODE_STEPS = 4


# sharded GQA on a model axis of 4: (heads, KV heads, head padding).  6
# heads do not divide over 4 ranks: padded to 8 (2 a rank, KV replicated)
# or, unpadded, every head on every rank; 8 heads over 4 KV heads split
# both, each rank its own KV head
GQA_CASES = {"6-padded": (6, 2, True), "6": (6, 2, False),
             "8-kv-split": (8, 4, False)}


def _gqa_cfg(cfg, case: str):
    h, kv, padding = GQA_CASES[case]
    return cfg.replace(n_heads=h, n_kv_heads=kv, attn_head_padding=padding)


# ---------------------------------------------------------------------------
# the ranks (no JAX here)
# ---------------------------------------------------------------------------


def _mesh(shape, names):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(WORLD).reshape(shape),
                      mesh_dim_names=names)


def _full(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _model(cfg, state):
    from repro_torch.models import transformer as tr

    model = tr.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    model.load_state_dict(state)
    return model


def _moe_part(inp, out, key):
    from repro_torch import configs
    from repro_torch.distributed import sharding
    from repro_torch.models import mlp

    for name in MOE_NAMES:
        cfg = configs.make_reduced(configs.get_config(name))
        x = torch.from_numpy(inp["moe_x"][name])
        p = mlp.init_moe(cfg, torch.Generator().manual_seed(0), "cpu")
        p.load_state_dict(inp["moe_w"][name])
        local, _ = mlp.moe_fwd(p, cfg, x)
        mesh = _mesh(MESHES[key], ("data", "model"))
        sharding.distribute(p, mesh)
        got, aux = mlp.moe_fwd(p, cfg, x, mesh=mesh)
        out[f"moe/{name}/{key}"] = (_full(got), local, _full(aux))


def _gqa_part(inp, out):
    from repro_torch import configs
    from repro_torch.distributed import compat, sharding
    from repro_torch.models import attention as attn

    base = configs.make_reduced(configs.get_config("qwen3-4b"))
    x = torch.from_numpy(inp["gqa_x"])
    b, s = x.shape[:2]
    pos = torch.arange(s)[None].expand(b, -1)
    mesh = _mesh((2, 4), ("data", "model"))
    # the cotangent of the forward's output, the same on every rank
    cot = torch.randn(x.shape, generator=torch.Generator().manual_seed(4))
    for case in GQA_CASES:
        cfg = _gqa_cfg(base, case)
        p = attn.init_gqa(cfg, torch.Generator().manual_seed(0), "cpu")
        p.load_state_dict(inp["gqa_w"][case])
        runs = []
        for sharded in (False, True):
            kw = {}
            if sharded:
                sharding.distribute(p, mesh)
                kw = {"mesh": mesh}
            p.requires_grad_(True)
            names, params = zip(*p.named_parameters())
            y = attn.gqa_fwd(p, cfg, x, pos, **kw)[0]
            c = compat.placed(cot, mesh, sharding.P(("data",))) if sharded \
                else cot
            grads = torch.autograd.grad((y * c).sum(), params)
            grads = {n: _full(g) for n, g in zip(names, grads)}
            p.requires_grad_(False)
            fwd = _full(y).detach()
            # token by token through a cache (the cache placed by kv_spec)
            cache = attn.init_gqa_cache(cfg, b, s, device="cpu")
            steps = [_full(attn.gqa_fwd(p, cfg, x[:, t:t + 1],
                                        pos[:, t:t + 1], cache=cache,
                                        cache_pos=t, **kw)[0])
                     for t in range(s)]
            runs.append((fwd, torch.cat(steps, 1), grads))
        out[f"gqa/{case}"] = runs


def _step_part(inp, out):
    from repro_torch import configs
    from repro_torch.distributed import sharding
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts

    mesh = _mesh((2, 4), ("data", "model"))
    c = opt.OptConfig(**inp["opt"])
    for name in STEP_NAMES:
        cfg = configs.make_reduced(configs.get_config(name))
        batch = {k: torch.from_numpy(v) for k, v in inp["batch"][name].items()}
        model = _model(cfg, inp["lm"][name])
        sharding.distribute(model, mesh, cfg=cfg)
        model.requires_grad_(True)
        loss, _ = ts.make_loss_fn(cfg, remat=False, mesh=mesh)(model, batch)
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = {n: None if g is None else _full(g)
                 for n, g in zip(names, grads)}
        state = opt.adamw_init(dict(model.named_parameters()), c)
        step = ts.make_train_step(cfg, c, remat=False, mesh=mesh)
        model, state, m = step(model, state, batch)
        zero = {n: [str(p) for p in state["m"][n].placements]
                for n in state["m"]}
        params = {n: _full(p).detach() for n, p in model.named_parameters()}
        twin = _model(cfg, inp["lm"][name])
        tstep = ts.make_train_step(cfg, c, remat=False, accum_steps=2)
        tstate = opt.adamw_init(dict(twin.named_parameters()), c)
        twin, _, tm = tstep(twin, tstate, batch)
        out[f"step/{name}"] = dict(
            metrics={k: float(v) for k, v in m.items()}, grads=grads,
            params=params, zero=zero,
            twin_metrics={k: float(v) for k, v in tm.items()},
            twin_params={n: p.detach() for n, p in twin.named_parameters()})


def _serve_part(inp, out):
    from repro_torch import configs
    from repro_torch.distributed import sharding
    from repro_torch.models import transformer as tr
    from repro_torch.training import train_step as ts

    mesh = _mesh((2, 4), ("data", "model"))
    for name in SERVE_NAMES:
        cfg = configs.make_reduced(configs.get_config(name))
        toks = torch.from_numpy(inp["batch"][name]["tokens"])
        prompt = toks[:, :8]
        runs = {}
        for sharded in (False, True):
            model = _model(cfg, inp["lm"][name])
            kw = {}
            if sharded:
                sharding.distribute(model, mesh, cfg=cfg)
                kw = {"mesh": mesh}
            logits = [_full(ts.make_prefill_step(cfg, **kw)(
                model, {"tokens": prompt}))]
            cache = tr.init_model_cache(cfg, toks.shape[0], 16, device="cpu")
            serve = ts.make_serve_step(cfg, **kw)
            for t in range(DECODE_STEPS):
                step_logits, cache = serve(model, cache, toks[:, t:t + 1], t)
                logits.append(_full(step_logits))
            runs[sharded] = logits
        out[f"serve/{name}"] = runs


def _compressed_part(inp, out, n_pod):
    import torch.distributed as dist

    from repro_torch.distributed.compression import compressed_psum
    from repro_torch.quantization import QUANTIZERS

    rank = dist.get_rank()
    mesh = (_mesh((8,), ("pod",)) if n_pod == 8
            else _mesh((n_pod, WORLD // n_pod), ("pod", "data")))
    base = torch.from_numpy(inp["psum_base"])
    for dtype in (torch.float32, torch.bfloat16):
        x = base.to(dtype)
        exact = x.float()
        for qname, qz in sorted(QUANTIZERS.items()):
            step_err = float(qz.error(exact).abs().max())
            reduced, err = compressed_psum({"g": x}, mesh, axis="pod",
                                           quantizer=qname)
            e1 = float((reduced["g"] - exact).abs().max())
            acc = reduced["g"]
            for _ in range(3):
                reduced, err = compressed_psum(
                    {"g": x}, mesh, axis="pod", error_state=err,
                    quantizer=qname)
                acc = acc + reduced["g"]
            ek = float((acc / 4 - exact).abs().max())
            out[f"psum/{n_pod}/{dtype}/{qname}"] = (step_err, e1, ek)
    # distinct inputs: each rank its own rows
    own = torch.from_numpy(inp["psum_own"][rank])
    for qname in sorted(QUANTIZERS):
        reduced, err = compressed_psum({"g": own}, mesh, axis="pod",
                                       quantizer=qname)
        errs = [torch.empty_like(err["g"]) for _ in range(WORLD)]
        dist.all_gather(errs, err["g"])
        means = [torch.empty_like(reduced["g"]) for _ in range(WORLD)]
        dist.all_gather(means, reduced["g"])
        out[f"psum_own/{n_pod}/{qname}"] = (torch.stack(means),
                                            torch.stack(errs))


def _pipeline_part(inp, out, n_stages):
    from repro_torch.distributed.pipeline_parallel import pipeline_apply

    mesh = _mesh((n_stages, WORLD // n_stages), ("stage", "data"))
    w = torch.from_numpy(inp["pipe_w"][n_stages])
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(inp["pipe_x"][str(dtype)[6:]]).to(dtype)
        got = pipeline_apply(lambda wp, h: torch.tanh(h @ wp), w.to(dtype),
                             x, mesh)
        out[f"pipe/{n_stages}/{dtype}"] = got.float()


def _restore_part(inp, out):
    import torch.distributed as dist

    from repro_torch.distributed import compat
    from repro_torch.distributed.sharding import P
    from repro_torch.training import checkpoint as ck

    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    mesh1 = _mesh((2, 4), ("data", "model"))
    path = ck.save(inp["ckpt"], {"w": compat.placed(w, mesh1,
                                                     P("data", "model"))})
    mesh2 = _mesh((4, 2), ("data", "model"))
    got, _ = ck.restore(path, {"w": w}, mesh=mesh2,
                        placements={"w": P("data", "model")})
    local = got["w"].to_local()
    rank = dist.get_rank()
    want = w[2 * (rank // 2):2 * (rank // 2) + 2,
             4 * (rank % 2):4 * (rank % 2) + 4]
    ok = torch.tensor(int(torch.equal(local, want)))
    dist.all_reduce(ok)
    out["restore"] = (_full(got["w"]), int(ok), got["w"].device_mesh.shape)


# one spawn per mesh layout: its parts, each (function, arguments)
SPAWNS = {
    "data x model 2x4": ((_moe_part, "2x4"), (_gqa_part,), (_step_part,),
                         (_serve_part,)),
    "data x model 4x2": ((_moe_part, "4x2"),),
    "pod 8": ((_compressed_part, 8),),
    "pod x data 4x2": ((_compressed_part, 4),),
    "stage x data 2x4": ((_pipeline_part, 2),),
    "stage x data 4x2": ((_pipeline_part, 4),),
    "2x4 saved, 4x2 restored": ((_restore_part,),),
}


def _rank_main(rank: int, port: int, layout: str, inp_path: str,
               out_path: str):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    inp = torch.load(inp_path, weights_only=False)
    out, times = {}, {}
    for fn, *args in SPAWNS[layout]:
        t0 = time.perf_counter()
        fn(inp, out, *args)
        times[fn.__name__] = time.perf_counter() - t0
    if rank == 0:
        out["times"] = times
        torch.save(out, out_path)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the reference (JAX, in the test process) and the spawn
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _inputs(tmp: Path) -> tuple:
    """The ranks' inputs (numpy and state dicts) and the JAX reference."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.configs.base import make_reduced as jmake_reduced
    from repro.models import attention as jattn
    from repro.models import mlp as jmlp
    from repro_torch.training.checkpoint import lm_params_from_jax
    from test_torch_lm_train import OPT, _batch, _reference

    inp = {"moe_x": {}, "moe_w": {}, "lm": {}, "batch": {}, "opt": OPT,
           "ckpt": str(tmp / "elastic.ckpt")}
    ref = {"moe": {}, "params": {}}
    for name in MOE_NAMES:
        jcfg = jmake_reduced(jconfigs.get_config(name))
        key = jax.random.PRNGKey(0)
        jp = jmlp.init_moe(key, jcfg)
        x = jax.random.normal(key, (4, 16, jcfg.d_model)) * 0.5
        ref["moe"][name] = np.asarray(jmlp.moe_fwd(jp, jcfg, x)[0])
        inp["moe_x"][name] = np.asarray(x)
        flat = {}
        for k, v in jp.items():
            for k2, v2 in (v.items() if isinstance(v, dict) else [(None, v)]):
                flat[k if k2 is None else f"{k}.{k2}"] = torch.tensor(
                    np.asarray(v2, np.float32))
        inp["moe_w"][name] = flat
    jbase = jmake_reduced(jconfigs.get_config("qwen3-4b"))
    gx = np.random.default_rng(3).normal(size=(4, 8, jbase.d_model)).astype(
        np.float32)
    pos = jnp.arange(8)[None].repeat(4, 0)
    inp["gqa_x"], inp["gqa_w"], ref["gqa"] = gx, {}, {}
    for case in GQA_CASES:
        qcfg = _gqa_cfg(jbase, case)
        gp = jattn.init_gqa(jax.random.PRNGKey(3), qcfg)
        ref["gqa"][case] = np.asarray(
            jattn.gqa_fwd(gp, qcfg, jnp.asarray(gx), pos)[0])
        inp["gqa_w"][case] = {k: torch.tensor(np.asarray(v, np.float32))
                              for k, v in gp.items()}
    for name in STEP_NAMES:
        jcfg, cfg, params = _reference(name)
        inp["lm"][name] = lm_params_from_jax(jax.tree.map(np.asarray, params),
                                             cfg)
        jbatch, batch = _batch(cfg)
        inp["batch"][name] = {k: v.numpy() for k, v in batch.items()}
        ref["params"][name] = (jcfg, params, jbatch)
    base = (jnp.ones((4, 64)) * 0.1 + jnp.arange(4)[:, None] * 0.01
            + jnp.linspace(-3, 3, 64)[None] * 0.05)
    inp["psum_base"] = np.asarray(base, np.float32)
    rng = np.random.default_rng(5)
    inp["psum_own"] = (rng.normal(size=(WORLD, 4, 64)) * np.linspace(
        0.1, 3.0, WORLD)[:, None, None]).astype(np.float32)
    inp["pipe_w"] = {}
    for n_stages in (2, 4):
        w = jax.random.normal(jax.random.PRNGKey(0),
                              (n_stages, 3, 16, 16)) / jnp.sqrt(16)
        inp["pipe_w"][n_stages] = np.asarray(w)
    # each dtype's input drawn in that dtype, as the reference test does
    inp["pipe_x"] = {dt: np.asarray(jax.random.normal(
        jax.random.PRNGKey(1), (6, 8, 16), getattr(jnp, dt)), np.float32)
        for dt in ("float32", "bfloat16")}
    return inp, ref


JAX_SHARDED_MOE = """
    import jax, jax.numpy as jnp, numpy as np
    from repro import configs
    from repro.configs.base import make_reduced
    from repro.models import mlp as mlp_mod
    out = {{}}
    for name in {names!r}:
        cfg = make_reduced(configs.get_config(name))
        key = jax.random.PRNGKey(0)
        p = mlp_mod.init_moe(key, cfg)
        x = jax.random.normal(key, (4, 16, cfg.d_model)) * 0.5
        for d, m in ((2, 4), (4, 2)):
            mesh = jax.make_mesh((d, m), ("data", "model"))
            got, _ = jax.jit(
                lambda p, x: mlp_mod.moe_fwd(p, cfg, x, mesh=mesh))(p, x)
            out[f"{{name}}/{{d}}x{{m}}"] = np.asarray(got)
    np.savez({path!r}, **out)
    print("SAVED")
"""


class _Runs:
    """The inputs, the JAX reference, and each layout's spawn, run once
    when a test first asks for its results."""

    def __init__(self, tmp: Path):
        import textwrap

        from conftest import ROOT

        self.tmp = tmp
        inp, self.ref = _inputs(tmp)
        self.inp_path = tmp / "inputs.pt"
        torch.save(inp, self.inp_path)
        env = dict(os.environ,
                   XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   PYTHONPATH=str(ROOT / "src"))
        # the reference's sharded MoE runs beside the ranks
        self.jax_moe = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(JAX_SHARDED_MOE.format(
                names=MOE_NAMES, path=str(tmp / "jax_moe.npz")))],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.results = {}

    def __call__(self, layout: str) -> dict:
        if layout not in self.results:
            self.results[layout] = self._spawn(layout)
        return self.results[layout]

    def _spawn(self, layout: str) -> dict:
        out_path = self.tmp / f"{layout.replace(' ', '_')}.pt"
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(_free_port(), layout, str(self.inp_path),
                              str(out_path)),
            nprocs=WORLD, join=False, start_method="spawn")
        deadline = time.monotonic() + SPAWN_TIMEOUT
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{layout}: ranks still running after "
                                       f"{SPAWN_TIMEOUT} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
        return torch.load(out_path, weights_only=False)

    def jax_sharded_moe(self) -> dict:
        if "moe_sharded" not in self.ref:
            stdout, stderr = self.jax_moe.communicate(timeout=JAX_TIMEOUT)
            assert self.jax_moe.returncode == 0 and "SAVED" in stdout, \
                stderr[-3000:]
            self.ref["moe_sharded"] = dict(np.load(self.tmp / "jax_moe.npz"))
        return self.ref["moe_sharded"]

    def close(self):
        if self.jax_moe.poll() is None:
            self.jax_moe.kill()
            self.jax_moe.communicate()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    r = _Runs(tmp_path_factory.mktemp("dist"))
    yield r
    r.close()


def _max_err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", MOE_NAMES)
def test_moe_sharded_parity(runs, name, mesh):
    got, local, aux = runs(f"data x model {mesh}")[f"moe/{name}/{mesh}"]
    assert got.shape == local.shape == (4, 16, 64)
    assert _max_err(got, runs.ref["moe"][name]) < MOE_TOL
    assert _max_err(got, local) < MOE_TOL
    assert _max_err(got, runs.jax_sharded_moe()[f"{name}/{mesh}"]) < MOE_TOL
    assert np.isfinite(float(aux)) and float(aux) > 0


@pytest.mark.parametrize("case", list(GQA_CASES))
def test_gqa_sharded(runs, case):
    """The forward, every weight's gradient of ``sum(y * cot)`` and a
    token-by-token cached decode on 2x4 (fp32) against the local ones
    within 1e-5 (the gradients relative to their largest), the forward
    also against the reference's.  Under head padding the padded weights
    are gathered and padded on every rank, each rank's cotangent covers
    its own heads only and the gather's backward sums them."""
    (fwd, dec, grads), (got_fwd, got_dec, got_grads) = runs(
        "data x model 2x4")[f"gqa/{case}"]
    assert _max_err(got_fwd, fwd) < GQA_TOL
    assert _max_err(got_fwd, runs.ref["gqa"][case]) < GQA_TOL
    assert got_dec.shape == dec.shape == fwd.shape
    assert _max_err(got_dec, dec) < GQA_TOL
    assert _max_err(dec, fwd) < GQA_TOL
    assert set(got_grads) == set(grads) >= {"wq", "wk", "wv", "wo"}
    for n, g in grads.items():
        assert _max_err(got_grads[n], g) <= GQA_TOL * np.abs(g.numpy()).max(), n


@pytest.mark.parametrize("name", STEP_NAMES)
def test_train_step_sharded_with_zero1_moments(runs, name):
    import jax

    from repro.training import optimizer as jopt
    from repro.training import train_step as jts
    from test_torch_lm_train import (GRAD_RTOL, LOSS_RTOL, OPT, SCALAR_ULPS,
                                     STEP_SPACINGS, _rel, _spacing,
                                     _unstacked)

    ref = runs.ref
    res = runs("data x model 2x4")[f"step/{name}"]
    jcfg, params, jbatch = ref["params"][name]
    jc = jopt.OptConfig(**OPT)
    jstep = jax.jit(jts.make_train_step(jcfg, jc, remat=False,
                                        accum_steps=2))
    jp, _, jm = jstep(params, jopt.adamw_init(params, jc), jbatch)
    m, tm = res["metrics"], res["twin_metrics"]
    for want in (float(jm["loss"]), tm["loss"]):
        assert abs(m["loss"] / want - 1) <= LOSS_RTOL
    for want in (float(jm["grad_norm"]), tm["grad_norm"]):
        assert abs(m["grad_norm"] / want - 1) <= LOSS_RTOL
    assert abs(m["lr"] - float(jm["lr"])) <= SCALAR_ULPS * _spacing(
        float(jm["lr"]))
    # every gradient, against the unsharded port's and the reference's of
    # the same loss (the mean of the two data shards' losses), within
    # GRAD_RTOL of the tensor's largest (read at most 4.4e-6, llama4)
    grads = res["grads"]
    assert all(g is not None for g in grads.values()), name
    for twin in (_twin_grads(name, ref), _jax_grads(name, ref)):
        for n, g in grads.items():
            g, t = g.numpy(), twin[n].numpy()
            assert np.abs(g - t).max() <= GRAD_RTOL * np.abs(t).max(), n
    # ZeRO-1: every moment that has a dim the data axis divides is split
    # on it; the updated parameters against both unsharded steps
    split = [n for n, pl in res["zero"].items() if pl[0].startswith("S(")]
    assert len(split) >= len(res["zero"]) // 2, res["zero"]
    jref = _unstacked(jp, _cfg(name))
    c_lr, c_eps = jc.lr, jc.eps
    clip = min(1.0, jc.grad_clip / (m["grad_norm"] + 1e-9))
    for n, p in res["params"].items():
        a = p.numpy()
        g = np.abs(grads[n].numpy()) * clip
        dg = GRAD_RTOL * g.max()
        for b in (jref[n].numpy(), res["twin_params"][n].numpy()):
            tol = (STEP_SPACINGS * _spacing(np.abs(b).max())
                   + np.minimum(2 * c_lr, c_lr * c_eps * dg / (g + c_eps) ** 2))
            assert (np.abs(a - b) <= tol).all(), (n, float(
                (np.abs(a - b) / tol).max()))


def _cfg(name):
    from repro_torch import configs

    return configs.make_reduced(configs.get_config(name))


def _twin_grads(name, ref):
    """The unsharded port gradient of the whole batch's loss over two
    micro-batches (the sharded loss's function)."""
    from repro_torch.training import train_step as ts
    from test_torch_lm_train import _models

    _, cfg, _, model = _models(name)
    _, _, jbatch = ref["params"][name]
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    model.requires_grad_(True)
    loss_fn = ts.make_loss_fn(cfg, remat=False)
    names, params = zip(*model.named_parameters())
    total = None
    for half in (slice(0, 2), slice(2, 4)):
        loss, _ = loss_fn(model, {k: v[half] for k, v in batch.items()})
        gs = torch.autograd.grad(loss, params, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g
              for p, g in zip(params, gs)]
        total = gs if total is None else [a + b for a, b in zip(total, gs)]
    return {n: g / 2 for n, g in zip(names, total)}


def _jax_grads(name, ref):
    """The reference's gradient of the same loss, its stacked leaves
    unrolled to the port's names."""
    import jax

    from repro.training import train_step as jts
    from test_torch_lm_train import _unstacked

    jcfg, params, jbatch = ref["params"][name]
    loss_fn = jts.make_loss_fn(jcfg, remat=False)
    grad = jax.jit(jax.grad(lambda p, b: loss_fn(p, b)[0]))
    halves = [grad(params, {k: v[half] for k, v in jbatch.items()})
              for half in (slice(0, 2), slice(2, 4))]
    total = jax.tree.map(lambda a, b: (a + b) / 2, *halves)
    return _unstacked(total, _cfg(name))


@pytest.mark.parametrize("name", SERVE_NAMES)
def test_prefill_and_serve_steps_sharded(runs, name):
    from test_torch_lm_train import _rel

    both = runs("data x model 2x4")[f"serve/{name}"]
    assert len(both[True]) == len(both[False]) == DECODE_STEPS + 1
    for got, want in zip(both[True], both[False]):
        assert got.shape == want.shape
        assert _rel(got.numpy(), want.numpy()) <= SERVE_RTOL


PSUM_LAYOUTS = {8: "pod 8", 4: "pod x data 4x2"}


@pytest.mark.parametrize("n_pod", [8, 4])
def test_compressed_psum_parity(runs, n_pod):
    """The reference parity test's checks, for fp32 and bf16 leaves and
    both quantizers: one sync within the local round trip's worst error,
    the mean over four syncs within half of it."""
    out = runs(PSUM_LAYOUTS[n_pod])
    seen = 0
    for dtype in (torch.float32, torch.bfloat16):
        for qname in ("log8", "rowwise"):
            step_err, e1, ek = out[f"psum/{n_pod}/{dtype}/{qname}"]
            assert e1 <= step_err * 1.01 + 1e-6, (qname, e1, step_err)
            assert ek <= e1 / 2 + 1e-6 or e1 < 1e-6, (qname, ek, e1)
            seen += 1
    assert seen == 4


@pytest.mark.parametrize("n_pod", [8, 4])
@pytest.mark.parametrize("qname", ["rowwise", "log8"])
def test_compressed_psum_distinct_inputs(runs, n_pod, qname):
    """Each rank's own input: its new error equal to JAX's
    ``fused_error_feedback_step`` on it within 1e-6 of the row's scale,
    and the reduction the mean of JAX's reconstructions over the ranks
    of its ``pod`` group (summed in fp64) within ``n_pod`` fp32 spacings
    of the mean of their magnitudes (an fp32 sum's rounding in any order:
    at most n - 1 roundings of partial sums no larger than n times that),
    the same bits on every rank of the group."""
    import jax.numpy as jnp

    from repro.quantization import fused_error_feedback_step

    means, errs = runs(PSUM_LAYOUTS[n_pod])[f"psum_own/{n_pod}/{qname}"]
    own = _inputs_own()
    recs, jerrs = [], []
    for r in range(WORLD):
        _, rec, err = fused_error_feedback_step(
            jnp.asarray(own[r]), jnp.zeros(own[r].shape, jnp.float32), qname)
        recs.append(np.asarray(rec, np.float64))
        jerrs.append(np.asarray(err))
    for r in range(WORLD):
        scale = np.abs(own[r]).max(axis=-1, keepdims=True)
        assert (np.abs(errs[r].numpy() - jerrs[r]) <= 1e-6 * scale).all(), r
    # rank 0's pod group: ranks 0..7 (pod 8) or 0, 2, 4, 6 (pod x data)
    group = range(WORLD) if n_pod == 8 else range(0, WORLD, 2)
    for r in group:
        assert torch.equal(means[r], means[0]), r
    reduced = means[0]
    want = sum(recs[r] for r in group) / n_pod
    size = sum(np.abs(recs[r]) for r in group) / n_pod
    assert (np.abs(reduced.numpy() - want) <= n_pod * _spacing32(size)).all()


def _spacing32(x):
    return np.spacing(np.maximum(np.abs(x).astype(np.float32),
                                 np.finfo(np.float32).tiny))


def _inputs_own():
    rng = np.random.default_rng(5)
    return (rng.normal(size=(WORLD, 4, 64)) * np.linspace(
        0.1, 3.0, WORLD)[:, None, None]).astype(np.float32)


@pytest.mark.parametrize("n_stages", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pipeline_apply_matches_sequential(runs, n_stages, dtype):
    import jax
    import jax.numpy as jnp

    out = runs(f"stage x data {n_stages}x{WORLD // n_stages}")
    jdt = getattr(jnp, dtype)
    w = jax.random.normal(jax.random.PRNGKey(0),
                          (n_stages, 3, 16, 16)) / jnp.sqrt(16)
    x = jax.random.normal(jax.random.PRNGKey(1), (6, 8, 16), jdt)
    seq = x
    for s in range(n_stages):
        for layer in range(3):
            seq = jnp.tanh(seq @ w[s, layer].astype(jdt))
    got = out[f"pipe/{n_stages}/{getattr(torch, dtype)}"]
    assert _max_err(got, np.asarray(seq, np.float32)) < PIPE_TOL[dtype]


def test_checkpoint_elastic_reshard(runs):
    full, ok, shape = runs("2x4 saved, 4x2 restored")["restore"]
    np.testing.assert_array_equal(
        full.numpy(), np.arange(64, dtype=np.float32).reshape(8, 8))
    assert ok == WORLD and tuple(shape) == (4, 2)
