"""Arm executor: runs the relay programs of the arms on real latents and
scores them with the quality oracles (port of
``repro/serving/executor.py``).

Runs are eager.  A program's pipeline — segment functions joined by
handoffs — is built once per program shape (family, roles, guidance,
per-hop wire format) and reused for every arm of that shape; segment
bounds arrive at call time.  A chain :class:`RelayGraph` normalizes to
its linear program and shares that program's pipeline; a branching graph
(Select and Merge joins) gets a graph pipeline built from the same
segment functions.

**Fused boundaries** (default on): compressed handoffs flow between
segment functions as the int8 wire payload — the emitting segment's last
step writes ``(q, s)`` (the fused emit kernel on CUDA) and the consuming
segment's first step reads it (the fused consume kernel).  Unfused,
a compressed hop is a standalone ``latent_roundtrip`` (the quant and
dequant kernels on CUDA).  A DAG node's emit also returns the payload's
Eq. 1 deviation, so it composes the step with the quant and dequant
kernels (``core/boundary.py``'s accounting flavors).

**Shared inputs.**  No segment function, hop or merge writes into its
input: the initial latent and an emitted payload read by several
consumers keep their bits (the reference donates buffers only where a
single consumer reads them; eager PyTorch needs no donation).

**Noise** is drawn on the host with ``torch.Generator`` and moved to the
device, so a CPU run and a card run of the same seeds start from the same
latent; :meth:`Executor.noise` and :meth:`Executor.run` are separate, so
a caller can feed the pipeline noise drawn elsewhere."""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import boundary, samplers
from repro_torch.core.program import (MERGE_NODE, SEGMENT_NODE, RelayGraph,
                                      RelayProgram, compile_plan,
                                      select_bound_pct)
from repro_torch.core.relay import fused_emits, hop_roundtrip, merge_latents
from repro_torch.device import keep_fp32, resolve_device
from repro_torch.diffusion import synth
from repro_torch.diffusion.families import Family, role_fn, role_params
from repro_torch.quantization import latent_roundtrip, relative_deviation
from repro_torch.serving import metrics
from repro_torch.serving.arms import ARMS, Arm
from repro_torch.serving.runtime.batching import DEFAULT_BUCKETS, bucketize


def sample_generator(arm_idx: int, seed: int) -> torch.Generator:
    """Host generator of one sample's noise, seeded from
    ``(arm.idx·7919, seed)``: a sample's noise depends on its own seed
    only, not on its bucket or its companions."""
    state = np.random.SeedSequence([arm_idx * 7919, int(seed)]).generate_state(
        2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))


class Executor:
    """Relay-program runner over loaded families.

    ``families`` must live on ``device`` (CUDA unless given; see
    :func:`repro_torch.diffusion.families.load_families`).  Determinism
    contract: :meth:`generate_bucketed` seeds each sample from its own
    seed, so a sample's noise depends on its seed only.  A ``subset=``
    re-run (the straggler re-issue) returns rows bit-identical to the
    same rows of the full call, on the CPU and on CUDA: it re-runs the
    whole micro-batch at the full call's bucket, rows and filler, and
    keeps the subset's rows, so every library call sees the shapes and
    inputs of the first run (cuBLAS and cuDNN choose their kernels by
    batch size, so a smaller bucket would move the last bits).  The cost:
    a re-issue computes the whole bucket, not just its stragglers."""

    def __init__(self, families: Dict[str, object],
                 arms: Optional[Sequence[Arm]] = None,
                 fused_boundary: bool = True, device=None):
        self.device = resolve_device(device)
        keep_fp32(self.device)
        self.families = families
        self.arms = tuple(arms) if arms is not None else ARMS
        self.fused_boundary = bool(fused_boundary)
        self._pipelines = {}  # (shape key, boundary formats) -> runner

    # ------------------------------------------------------------------
    # pipelines
    # ------------------------------------------------------------------

    def _segment_fn(self, family: str, role: str, guidance: float,
                    in_q: Optional[str] = None, out_q: Optional[str] = None,
                    out_flavor: str = "wire"):
        """One segment's sampler over call-time bounds.  ``in_q`` /
        ``out_q`` name the wire quantizer of a fused boundary on the input
        / output side: with ``in_q`` the latent argument is the ``(q, s)``
        payload and the first step consumes it; with ``out_q`` the last
        step emits the payload.  ``out_flavor`` picks what the emit returns
        (``boundary.EMIT_FLAVORS``): "wire" ``(q, s)``, "wire_dev" ``((q,
        s), Eq. 1 deviation)``, "wire_dev_latent" also the stepped latent
        (a DAG node whose other consumers read the latent)."""
        fam = self.families[family]
        net = role_fn(fam, role)
        kind = fam.spec.kind
        latent_shape = tuple(fam.spec.latent_shape)
        sigmas = fam.spec.ladder(role)
        sample = samplers.sampler_for(kind)

        def fn(params, x, cond, start, stop):
            if in_q:
                q, s = x
                x = boundary.dequant_step(
                    kind, net, params, {"q": q, "s": s}, latent_shape,
                    sigmas, start, cond, None, guidance, quantizer=in_q,
                )
                start += 1
            if out_q:
                x, _ = sample(net, params, x, sigmas, cond, start=start,
                              stop=stop - 1, guidance=guidance,
                              capture_traj=False)
                res = boundary.quant_step(
                    kind, net, params, x, sigmas, stop - 1, cond, None,
                    guidance, quantizer=out_q, flavor=out_flavor,
                )
                w = (res["wire"]["q"], res["wire"]["s"])
                if out_flavor == "wire":
                    return w
                if out_flavor == "wire_dev":
                    return w, res["dev_pct"]
                return w, res["dev_pct"], res["latent"]
            out, _ = sample(net, params, x, sigmas, cond, start=start,
                            stop=stop, guidance=guidance, capture_traj=False)
            return out

        return fn

    def _require_mid(self, family: str, segments) -> None:
        """Refuse a program with a mid segment on a family loaded without
        its mid-size weights."""
        fam = self.families[family]
        if (isinstance(fam, Family) and not fam.has_mid
                and any(s.model == "mid" for s in segments)):
            raise ValueError(
                f"family {family} has no trained mid-size stage — "
                f"load families with with_mid=True to run cascade programs"
            )

    def _pipeline(self, program: "RelayProgram | RelayGraph"):
        """Runner ``run(x0, cond, bounds)`` for a program's shape.  A chain
        :class:`RelayGraph` normalizes to its linear program (sharing that
        program's pipeline, bit for bit); a branching graph goes to
        :meth:`_graph_pipeline`."""
        if isinstance(program, RelayGraph):
            plan = compile_plan(program)
            if not plan.is_chain:
                return self._graph_pipeline(program, plan)
            program = plan.linear_program()
        fused = self.fused_boundary
        if fused:
            # validated per concrete program, before the shape lookup
            for k, seg in enumerate(program.segments):
                fin = k > 0 and program.handoffs[k - 1].compress
                fout = (k < program.n_hops and program.handoffs[k].compress)
                if fin and fout and seg.steps < 2:
                    raise ValueError(
                        f"segment {k} of the {program.family} program has "
                        "too few steps to both consume and emit a fused "
                        "boundary (needs >= 2)"
                    )
        bfmt = tuple(
            ("fused" if fused else "roundtrip", h.quantizer) if h.compress
            else ("raw", None)
            for h in program.handoffs
        )
        key = (program.shape_key(), bfmt)
        if key in self._pipelines:
            return self._pipelines[key]
        self._require_mid(program.family, program.segments)
        fam = self.families[program.family]

        def _hop_q(k):  # wire quantizer of hop k when fused, else None
            hs = program.handoffs
            return (hs[k].quantizer
                    if fused and 0 <= k < len(hs) and hs[k].compress else None)

        seg_fns = [
            self._segment_fn(program.family, seg.model, seg.guidance,
                             in_q=_hop_q(k - 1), out_q=_hop_q(k))
            for k, seg in enumerate(program.segments)
        ]
        roles = [seg.model for seg in program.segments]
        hop_qs = [h.quantizer if h.compress and not fused else None
                  for h in program.handoffs]

        def run(x, cond, bounds):
            for k, (fn, role) in enumerate(zip(seg_fns, roles)):
                x = fn(role_params(fam, role), x, cond, *bounds[k])
                if k < len(hop_qs) and hop_qs[k] is not None:
                    x, _ = latent_roundtrip(x, hop_qs[k])
            return x

        self._pipelines[key] = run
        return run

    def _graph_pipeline(self, graph: RelayGraph, plan):
        """Runner ``run(x0, cond, bounds)`` for a branching DAG plan, from
        the same segment functions as linear programs: hop edges are wire
        round trips with their Eq. 1 deviation, Merge nodes the k-way
        latent average, Select nodes an eager decision over the whole
        batch (the candidate's Eq. 1 deviation from the reference latent
        against the node's bound)."""
        fused = self.fused_boundary
        # The fused-boundary analysis of the concrete plan runs before the
        # cache lookup, so the too-few-steps check covers every plan
        # sharing a shape.
        fused_edges, emits = (fused_emits(plan) if fused
                              else (frozenset(), {}))
        emit_cfg = {nid: (q, "wire_dev_latent" if need_latent else "wire_dev")
                    for nid, (q, need_latent) in emits.items()}
        for n in plan.nodes:
            consumed = any(e in fused_edges for e in plan.preds[n.nid])
            if n.nid in emit_cfg and n.segment.steps < (2 if consumed else 1):
                raise ValueError(
                    f"graph node {n.nid} has too few steps to both "
                    "consume and emit a fused boundary"
                )
        key = (graph.shape_key(), fused)
        if key in self._pipelines:
            return self._pipelines[key]
        self._require_mid(graph.family, graph.segments)
        fam = self.families[graph.family]

        def _in_q(n):  # quantizer of a fused payload the node consumes
            pe = plan.preds[n.nid]
            fused_in = pe and pe[0] in fused_edges
            return pe[0].handoff.quantizer if fused_in else None

        seg_fns = {
            n.nid: self._segment_fn(
                graph.family, n.segment.model, n.segment.guidance,
                in_q=_in_q(n), out_q=emit_cfg.get(n.nid, (None,))[0],
                out_flavor=emit_cfg.get(n.nid, (None, "wire"))[1])
            for n in plan.nodes if n.kind == SEGMENT_NODE
        }

        def run(x0, cond, bounds):
            out, wire, path_dev = {}, {}, {}
            for i, node in enumerate(plan.nodes):
                pe = plan.preds[node.nid]
                if node.kind == SEGMENT_NODE:
                    if not pe:
                        x_in, d_in = x0, 0.0
                    elif pe[0] in fused_edges:
                        # the first step reads the payload the src emitted
                        e = pe[0]
                        x_in, dev = wire[e.src]
                        d_in = max(path_dev[e.src], float(dev))
                    else:
                        e = pe[0]
                        x_in, d_in = out[e.src], path_dev[e.src]
                        if e.handoff is not None and e.handoff.compress:
                            x_in, _, dev = hop_roundtrip(
                                x_in, e.handoff.quantizer)
                            d_in = max(d_in, float(dev))
                    res = seg_fns[node.nid](
                        role_params(fam, node.segment.model), x_in, cond,
                        *bounds[i])
                    cfg = emit_cfg.get(node.nid)
                    if cfg is None:
                        out[node.nid] = res
                    else:
                        wire[node.nid] = (res[0], res[1])
                        if cfg[1] == "wire_dev_latent":
                            out[node.nid] = res[2]
                    path_dev[node.nid] = d_in
                elif node.kind == MERGE_NODE:
                    out[node.nid] = merge_latents([out[e.src] for e in pe])
                    path_dev[node.nid] = max(path_dev[e.src] for e in pe)
                else:  # SELECT_NODE: one decision over the whole batch
                    sel = plan.selects[node.nid]
                    ref, cand = sel.reference, sel.candidates[0]
                    dev_cand = float(
                        relative_deviation(out[ref], out[cand]) * 100.0)
                    base = path_dev[ref]
                    bound = select_bound_pct(node, base if base > 0.0 else 1.0)
                    winner = cand if dev_cand <= bound else ref
                    out[node.nid] = out[winner]
                    # the winner's own path deviation, as the reference's
                    # pipeline keeps it (execute_graph takes the max with
                    # dev_cand after an accept: the reference's two
                    # coordinators differ here, and each is ported as is)
                    path_dev[node.nid] = path_dev[winner]
            return out[plan.sink]

        self._pipelines[key] = run
        return run

    @staticmethod
    def _bounds(program):
        """Call-time ``(start, stop)`` per segment; for a branching graph,
        per canonical node (``()`` at join nodes)."""
        if isinstance(program, RelayGraph):
            plan = compile_plan(program)
            if not plan.is_chain:
                return [(n.segment.start, n.segment.stop)
                        if n.kind == SEGMENT_NODE else ()
                        for n in plan.nodes]
            program = plan.linear_program()
        return [(seg.start, seg.stop) for seg in program.segments]

    # ------------------------------------------------------------------
    # generation
    # ------------------------------------------------------------------

    def noise(self, arm: Arm, seeds, per_sample: bool) -> torch.Tensor:
        """Initial latents on the host: one generator per sample
        (:func:`sample_generator`) with ``per_sample``, else one per batch
        seeded from ``seeds[0]·7919 + arm.idx``."""
        shape = tuple(self.families[arm.program.family].spec.latent_shape)
        if per_sample:
            return torch.stack([
                torch.randn(shape, generator=sample_generator(arm.idx, s))
                for s in seeds
            ])
        gen = torch.Generator().manual_seed(int(seeds[0]) * 7919 + arm.idx)
        return torch.randn((len(seeds),) + shape, generator=gen)

    def run(self, arm: Arm, x0: torch.Tensor, cond) -> torch.Tensor:
        """Run the arm's program from initial latents ``x0`` (B, H, W, C)
        with conditioning ``cond`` (B, cond_dim); returns the final latents
        on the executor's device."""
        pipeline = self._pipeline(arm.program)
        with torch.inference_mode():
            return pipeline(
                torch.as_tensor(x0, dtype=torch.float32).to(self.device),
                torch.as_tensor(cond, dtype=torch.float32).to(self.device),
                self._bounds(arm.program),
            )

    def generate(self, arm: Arm, seeds: np.ndarray) -> np.ndarray:
        """Run the arm's program for a batch sharing one generator (seeded
        from ``seeds[0]``); returns the final latents as numpy."""
        _, _, cond = synth.batch(seeds, arm.family or "XL")
        out = self.run(arm, self.noise(arm, seeds, per_sample=False), cond)
        return out.cpu().numpy()

    def generate_bucketed(self, arm: Arm, seeds: np.ndarray,
                          buckets=DEFAULT_BUCKETS, subset=None) -> np.ndarray:
        """Pad-to-bucket batched generation with per-sample noise: padded
        slots re-run the last seed and are sliced off.  ``subset`` —
        indices into ``seeds`` — returns only those samples' rows (the
        straggler re-issue path), computed by the full call's run, so they
        equal its rows bit for bit (see :class:`Executor`)."""
        seeds = np.asarray(seeds)
        idx = None
        if subset is not None:
            idx = np.asarray(subset, dtype=np.intp)
            if idx.size == 0:
                raise ValueError("empty subset: nothing to re-execute")
        n = len(seeds)
        b = bucketize(n, tuple(sorted(buckets)))
        if b == 1 and self.device.type == "cpu":
            # PyTorch's CPU matrix product takes another summation order
            # for a single row; beside a copy of itself a lone sample keeps
            # its row's bits.  (On CUDA no bucket size keeps them; only a
            # subset re-run, which repeats the full call, does.)
            b = 2
        if b > n:
            seeds = np.concatenate([seeds, np.repeat(seeds[-1:], b - n)])
        _, _, cond = synth.batch(seeds, arm.family or "XL")
        out = self.run(arm, self.noise(arm, seeds, per_sample=True), cond)
        out = out.cpu().numpy()[:n]
        return out if idx is None else out[idx]

    def quality_table(self, seeds: np.ndarray, arms=None) -> np.ndarray:
        """(N, n_arms) array of metric dicts, columns indexed by
        ``arm.idx``; ``arms`` may restrict which columns are filled but
        must belong to this executor's action space."""
        arms = arms if arms is not None else self.arms
        bad = [a.label for a in arms if a.idx >= len(self.arms)]
        if bad:
            raise ValueError(
                f"arms outside this executor's {len(self.arms)}-arm action "
                f"space: {bad} — construct the Executor with those arms"
            )
        prompts = [synth.sample_prompt(int(s)) for s in seeds]
        table = np.empty((len(seeds), len(self.arms)), dtype=object)
        for arm in arms:
            gen = self.generate(arm, seeds)
            for i, p in enumerate(prompts):
                table[i, arm.idx] = metrics.quality_metrics(gen[i], p)
        return table
