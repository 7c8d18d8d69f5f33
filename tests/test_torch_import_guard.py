"""The port stands alone: every ``repro_torch`` module imports, and toy
diffusion relays (F3's guided by an unconditional input), the DAG arms
(``execute_graph`` and the executor's graph pipeline), the interior
step's wrapper, reduced LM relays (dense, traced and exported, and
RecurrentGemma), the scheduler (RISE, PPO, the handoff transport, one
federated gossip, the LinUCB snapshot), the parts the engines stand on
(the event queue, the aggregator, the telemetry, the serving context, the
synthetic workload), both serving engines (8 requests, raw and
compressed), a two-cluster fleet (locality routing, autoscaled,
federated RISE gossiping), one training step of a narrow denoiser with
its checkpoint written and read back, the four Table III baselines on
toy nets, and one step of the LM training driver on a reduced
configuration with its checkpoint written and read back, run on the CPU,
in a process where ``jax`` and
the reference package ``repro`` cannot be imported; no port source
imports either."""
from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"

_GUARDED = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None       # any `import jax` now raises ImportError
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)

import torch
from repro_torch.core.relay import execute_program
from repro_torch.diffusion.families import SPECS
from repro_torch.serving.arms import relay_program

toy = lambda p, x, t, c: 0.5 * x + 0.05 * torch.tanh(x)
models = {r: (toy, None) for r in ("large", "small")}
x = torch.randn(2, 8, 8, 4, generator=torch.Generator().manual_seed(0))
for fam in ("XL", "F3"):
    for fused in (False, True):
        prog = relay_program(fam, 15, compress=True)
        out, info = execute_program(SPECS[fam](), prog, models, x, None,
                                    fused_boundary=fused)
        assert out.shape == x.shape and torch.isfinite(out).all()
        assert info["transfer_bytes"] == 2 * 4 * 64 + 2 * 4 * 4

# the DAG arms: execute_graph and the executor's graph pipeline
from types import SimpleNamespace

import numpy as np
from repro_torch.core.program import select_outcome, compile_plan
from repro_torch.core.relay import execute_graph
from repro_torch.serving.arms import dag_action_space
from repro_torch.serving.executor import Executor

dag = dag_action_space()[11:]
models["mid"] = (toy, None)
for arm in dag:
    spec = SPECS[arm.program.family]()
    for fused in (False, True):
        out, info = execute_graph(spec, arm.program, models, x, None,
                                  fused_boundary=fused)
        assert out.shape == x.shape and torch.isfinite(out).all()
        assert len(info["joins"]) == 1
fams = {f: SimpleNamespace(spec=SPECS[f](), large_fn=toy, small_fn=toy,
                           mid_fn=toy, large_params=None, small_params=None,
                           mid_params=None) for f in ("XL", "F3")}
ex = Executor(fams, arms=dag_action_space(), device="cpu")
for arm in dag:
    assert ex.generate_bucketed(arm, np.arange(3)).shape == (3, 8, 8, 4)
assert select_outcome(compile_plan(dag[0].program), "select", 0.5, 0.4)[2] \
    == 1.1 * 0.4

# the interior step's kernel wrapper, and F3's guided relay through it
from repro_torch.core.program import make_program
from repro_torch.kernels.fused_sampler.ops import fused_cfg_step
from repro_torch.kernels.fused_sampler.ref import ddim_coeffs

c1, c2 = ddim_coeffs(0.4, 0.6)
y = fused_cfg_step(x, x, x.flip(0), guidance=3.5, c1=c1, c2=c2, mode="ddim")
assert y.shape == x.shape and torch.isfinite(y).all()
guided = lambda p, x, t, c: 0.5 * x + 0.05 * c.mean() * torch.tanh(x)
cond = torch.ones(2, 4)
spec = SPECS["F3"]()
route = [("large", "p0", 15), ("small", "p1", None)]
outs = [execute_program(spec, make_program(spec, route, guidance=g,
                                           compress=True),
                        {r: (guided, None) for r in ("large", "small")}, x,
                        cond, uncond=torch.zeros_like(cond),
                        fused_boundary=True)[0] for g in (1.0, 3.5)]
assert all(torch.isfinite(o).all() for o in outs)
assert not torch.equal(outs[0], outs[1])

from repro_torch import configs
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import transformer as tr
from repro_torch.serving.lm_relay import relay_decode, sequence_logprob
from repro_torch.training.data import DataConfig, TokenPipeline

cfg = configs.make_reduced(configs.get_config("qwen3-4b"))
large, small = (tr.init_model(cfg, torch.Generator().manual_seed(k), "cpu")
                for k in (0, 1))
prompt = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=3,
                                  global_batch=2)).batch(0)[0]
from repro_torch.serving.obs import (SpanTracer, to_chrome_trace,
                                     validate_chrome_trace)

tracer = SpanTracer()
seq, info = relay_decode(large, cfg, small, cfg, prompt, 2, 4, tracer=tracer,
                         rid=3, device="cpu")
assert seq.shape == (2, 7) and info["transfer_bytes"] == 2 * (3 + 2) * 4
assert tracer.requests[3].t_total == tracer.requests[3].attributed_s() == 4.0
assert validate_chrome_trace(to_chrome_trace(tracer)) == []
assert torch.isfinite(torch.tensor(sequence_logprob(large, cfg, seq,
                                                    device="cpu")))
q = torch.randn(1, 4, 5, 16)
assert flash_attention(q, q[:, :2], q[:, :2], kv_len=3).shape == q.shape

from repro_torch.kernels.rglru.ops import rglru_scan

rg = configs.make_reduced(configs.get_config("recurrentgemma-9b"))
large, small = (tr.init_model(rg, torch.Generator().manual_seed(k), "cpu")
                for k in (2, 3))
seq, info = relay_decode(large, rg, small, rg, prompt, 3, 6, device="cpu")
assert seq.shape == (2, 9) and info["transfer_bytes"] == 2 * (3 + 3) * 4
assert torch.isfinite(torch.tensor(sequence_logprob(large, rg, seq,
                                                    device="cpu")))
a = torch.rand(2, 5, 3)
assert rglru_scan(a, a).shape == a.shape

# the scheduler: RISE selects and updates, PPO selects, the transport
# measures a round trip, and one gossip merges two clusters
from repro_torch.core.policies import PPOPolicy, RisePolicy
from repro_torch.serving.fleet import FederatedRisePolicy, LinUCBFederation
from repro_torch.serving.runtime import HandoffTransport

ctx, avail = np.full(8, 0.5, np.float32), np.ones(11, bool)
rise = RisePolicy(device="cpu")
arm = rise.select(ctx, avail)
rise.update(ctx, arm, 1.0)
assert 0 <= arm < 11 and float(rise.state.counts.sum()) == 1.0
assert 0 <= PPOPolicy(device="cpu").select(ctx, avail) < 11
assert 0.0 < HandoffTransport(device="cpu").handoff_error("XL") < 0.02
pols = [FederatedRisePolicy(seed=3, device="cpu") for _ in range(2)]
fed = LinUCBFederation(pols)
for p in pols:
    p.update(ctx, 2, 0.5)
merged = fed.gossip()
assert float(merged.counts[2]) == 2.0

# the parts the engines stand on: the LinUCB snapshot, the event queue,
# the aggregator, the telemetry export and every serving/context.py function
from repro_torch.core.context import Request
from repro_torch.serving import context as sctx
from repro_torch.serving.arms import ARMS, POOL_REPLICAS
from repro_torch.serving.obs import export_runtime_telemetry, linucb_snapshot
from repro_torch.serving.runtime import (EventQueue, MicroBatchAggregator,
                                         RuntimeTelemetry, WorkItem)
from repro_torch.serving.workload import CyclePolicy, synthetic_quality_table

assert sum(linucb_snapshot(rise)["pulls"]) == 1
evq = EventQueue()
for t, kind in ((2.0, "flush"), (1.0, "arrive"), (1.0, "batch_done")):
    evq.push(t, kind)
assert [evq.pop()[1] for _ in range(3)] == ["arrive", "batch_done", "flush"]
req = Request(0, 0.0, 0.5, True, 80.0, 0.9, 0.5)
agg = MicroBatchAggregator(ARMS[3].edge_pool)
agg.push(WorkItem(req, 3, "edge", ARMS[3].edge_pool, 15), 0.0)
items, bucket = agg.next_batch(1.0)
assert [it.rid for it in items] == [0] and bucket == 1
tel = RuntimeTelemetry()
tel.record_batch(agg.pool, 1, bucket, 0.5, False)
assert export_runtime_telemetry(tel)[agg.pool]["n_batches"] == 1
cfg = SimpleNamespace(seed=1, max_queue=4, straggler_prob=0.5,
                      straggler_factor=4.0, straggler_reissue=2.5,
                      straggler_mode="item", pool_replicas=None,
                      fail_replica=("vega", 0, 1.0, 2.0))
occ = sctx.aggregate_occupancy({p: 0.5 for p in POOL_REPLICAS})
assert occ == {"vega": 0.5, "sdxl": 0.5, "sd3": 0.5}
assert sctx.pool_key("sd3m") == "sd3" and sctx.backlog_horizon(cfg) == 40.0
assert sctx.pool_inventory(cfg) == POOL_REPLICAS
assert sctx.failure_schedule(cfg) == (("vega", 0, 1.0, 2.0),)
assert sctx.fallback_avail(ARMS, dict.fromkeys(POOL_REPLICAS, 0)).all()
assert sctx.straggler_mode(cfg) == "item"
assert sctx.straggler_slow(cfg, 5) in (1.0, 4.0)
assert len(sctx.partition_stragglers(cfg, range(8))[2]) == 8
assert sctx.context_dim(True) == 10
assert sctx.telemetry_features(2.0, 0.5).tolist() == [1.0, 0.5]
assert synthetic_quality_table([req]).shape == (1, 11)
assert CyclePolicy().select(ctx, avail) == 0

# both serving engines over the synthetic table, raw and compressed: the
# sequential loop and the continuous-batching runtime (the default)
from repro_torch.launch.serve import resolve_runtime_config
from repro_torch.serving.engine import (ServingEngine, SimConfig,
                                        make_requests, summarize)
from repro_torch.serving.runtime import ContinuousRuntime, RuntimeConfig

sim = SimConfig(n_requests=8, mean_interarrival=1.0, seed=2)
reqs = make_requests(sim)
table = synthetic_quality_table(reqs)
served = []
for runtime, rc in (("sequential", None), ("sequential", RuntimeConfig()),
                    ("continuous", RuntimeConfig(compress_handoff=False)),
                    ("continuous", resolve_runtime_config("continuous",
                                                          False))):
    eng = ServingEngine(CyclePolicy(), table, sim, runtime=runtime,
                        runtime_cfg=rc, device="cpu")
    recs = sorted(eng.run(reqs), key=lambda r: r.rid)
    assert [r.arm for r in recs] == list(range(8))
    assert all(np.isfinite(r.reward) and r.t_total > 0 for r in recs)
    assert eng.tracer.coverage() == 1.0
    served.append(summarize(recs))
assert served[0]["arm_histogram"] == served[2]["arm_histogram"]
assert served[1]["clip"] < served[0]["clip"]
assert served[3]["clip"] < served[2]["clip"]
rt = ContinuousRuntime(CyclePolicy(), table, sim, RuntimeConfig(),
                       device="cpu")
assert len(rt.run(reqs)) == 8 and rt.idle()

# the fleet: two clusters (one replica per pool in the second), the
# locality router, autoscaled, federated RISE gossiping every 3 s
from repro_torch.serving.fleet import (AutoscaleConfig, ClusterSpec,
                                       FleetConfig, FleetEngine)

fleet = FleetConfig(clusters=(
    ClusterSpec("a", region="east"),
    ClusterSpec("b", region="west",
                pool_replicas=dict.fromkeys(POOL_REPLICAS, 1))),
    router="locality", gossip_period_s=3.0)
pols = [FederatedRisePolicy(seed=k, device="cpu") for k in range(2)]
eng = FleetEngine(fleet, sim, table, pols, autoscale=AutoscaleConfig(),
                  region_of=lambda r: ("east", "west")[r.rid % 2],
                  device="cpu")
res = eng.run(reqs)
assert [r.rid for r in res.records] == list(range(8))
assert sorted(res.assignments) == list(range(8)) and res.n_gossips >= 1
assert float(eng.federation.base.counts.sum()) >= 1.0
assert all(t.autoscale.ticks > 0 for t in res.telemetry)

# diffusion training: one step of a narrow net, a checkpoint written and
# read back; the Table III baselines on toy nets
import tempfile

from repro_torch.core import accel_baselines as ab
from repro_torch.diffusion import train
from repro_torch.diffusion.synth import batch as synth_batch
from repro_torch.models.diffusion_nets import DiffNetConfig, init_net
from repro_torch.training import checkpoint as ck

narrow = DiffNetConfig("mmdit", width=8, depth=1)
gen = torch.Generator().manual_seed(0)
net = init_net(narrow, gen)
opt = train.Adam(net)
_, x0, c0 = synth_batch(range(4), "F3")
x0, c0 = torch.from_numpy(x0), torch.from_numpy(c0)
t, noise = train._draw_f3(gen, x0)
before = net.patch.detach().clone()
loss = train.train_step(opt, lambda: train._loss_f3(net, x0, c0, t, noise),
                        1, 1, 3e-3)
assert torch.isfinite(loss) and not torch.equal(net.patch, before)
with tempfile.TemporaryDirectory() as tmp:
    flat = ck.params_to_jax(net.state_dict(), narrow)
    back = ck.load_flat(ck.save(f"{tmp}/n.ckpt", flat))
    assert list(back) == list(flat)
for fam in ("XL", "F3"):
    spec = SPECS[fam]()
    for sample in (ab.full_sample, ab.deepcache_sample, ab.tgate_sample,
                   ab.sada_sample):
        out, evals = sample(spec.kind, toy, None, x, spec.sigmas_edge,
                            torch.zeros(2, 16))
        assert out.shape == x.shape and torch.isfinite(out).all()
        assert 0 < evals <= len(spec.sigmas_edge) - 1

# the LM training driver: one reduced step on the CPU, its checkpoint
# written and read back into a fresh model
import contextlib, io
from repro_torch.launch import train as launch_train
from repro_torch.training.optimizer import OptConfig, adamw_init

with tempfile.TemporaryDirectory() as tmp, \
        contextlib.redirect_stdout(io.StringIO()) as log:
    losses = launch_train.main(["--arch", "granite-8b", "--steps", "1",
                                "--batch", "2", "--seq", "8", "--device",
                                "cpu", "--ckpt-dir", tmp])
    assert log.getvalue().startswith("done: loss")
    assert len(losses) == 1 and np.isfinite(losses[0])
    lm_cfg = configs.make_reduced(configs.get_config("granite-8b"))
    lm = tr.init_model(lm_cfg, torch.Generator().manual_seed(5), "cpu")
    state = adamw_init(dict(lm.named_parameters()), OptConfig())
    flat, meta = ck.restore(f"{tmp}/granite-8b",
                            ck.lm_state_to_jax(lm, state, lm_cfg))
    state = ck.lm_state_from_jax(flat, lm, lm_cfg)
    assert meta == {"step": 1, "arch": "granite-8b"}
    assert int(state["count"]) == 1
print("ok", len(names))
"""


def test_port_imports_and_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-c", _GUARDED], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("ok")


def test_no_port_source_imports_jax_or_the_reference():
    bad = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)[\s.])",
                     re.M)
    sources = sorted(PORT.rglob("*.py"))
    assert sources
    offenders = [str(p.relative_to(REPO)) for p in sources
                 if bad.search(p.read_text())]
    assert offenders == []
    smoke = (REPO / "chip_smoke.py").read_text()
    assert not bad.search(smoke)
