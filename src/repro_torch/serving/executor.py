"""Arm executor: runs the relay programs of the arms on real latents and
scores them with the quality oracles (port of
``repro/serving/executor.py``, linear programs only).

Runs are eager.  A program's pipeline — segment functions joined by
handoffs — is built once per program shape (family, roles, guidance,
per-hop wire format) and reused for every arm of that shape; segment
bounds arrive at call time.

**Fused boundaries** (default on): compressed handoffs flow between
segment functions as the int8 wire payload — the emitting segment's last
step writes ``(q, s)`` (the fused emit kernel on CUDA) and the consuming
segment's first step reads it (the fused consume kernel).  Unfused,
a compressed hop is a standalone ``latent_roundtrip`` (the quant and
dequant kernels on CUDA).

**Noise** is drawn on the host with ``torch.Generator`` and moved to the
device, so a CPU run and a card run of the same seeds start from the same
latent; :meth:`Executor.noise` and :meth:`Executor.run` are separate, so
a caller can feed the pipeline noise drawn elsewhere."""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import boundary, samplers
from repro_torch.core.program import RelayProgram
from repro_torch.device import resolve_device
from repro_torch.diffusion import synth
from repro_torch.diffusion.families import role_fn, role_params
from repro_torch.quantization import latent_roundtrip
from repro_torch.serving import metrics
from repro_torch.serving.arms import ARMS, Arm

DEFAULT_BUCKETS = (1, 2, 4, 8)


def bucketize(n: int, buckets=DEFAULT_BUCKETS) -> int:
    """Smallest bucket ≥ n (n must not exceed the largest bucket)."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} exceeds largest bucket {buckets[-1]}")


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
        if self.device.type == "cuda":
            # cuDNN runs fp32 convolutions in TF32 by default, and TF32
            # keeps about 3 decimal digits; the port is held to the fp32
            # reference, so both TF32 switches stay off.
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.families = families
        self.arms = tuple(arms) if arms is not None else ARMS
        self.fused_boundary = bool(fused_boundary)
        self._pipelines = {}  # (shape key, boundary formats) -> runner

    # ------------------------------------------------------------------
    # pipelines
    # ------------------------------------------------------------------

    def _segment_fn(self, family: str, role: str, guidance: float,
                    in_q: Optional[str] = None, out_q: Optional[str] = None):
        """One segment's sampler over call-time bounds.  ``in_q`` /
        ``out_q`` name the wire quantizer of a fused boundary on the input
        / output side: with ``in_q`` the latent argument is the ``(q, s)``
        payload and the first step consumes it; with ``out_q`` the last
        step emits the payload and the segment returns ``(q, s)``."""
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
                    guidance, quantizer=out_q, flavor="wire",
                )
                return res["wire"]["q"], res["wire"]["s"]
            out, _ = sample(net, params, x, sigmas, cond, start=start,
                            stop=stop, guidance=guidance, capture_traj=False)
            return out

        return fn

    def _pipeline(self, program: RelayProgram):
        """Runner ``run(x0, cond, bounds)`` for a program's shape."""
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
        fam = self.families[program.family]
        if (any(s.model == "mid" for s in program.segments)
                and getattr(fam, "mid_params", None) is None):
            raise ValueError(
                f"family {program.family} has no mid-size stage — load "
                f"families with with_mid=True to run cascade programs"
            )

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
        prog = arm.program
        pipeline = self._pipeline(prog)
        bounds = [(seg.start, seg.stop) for seg in prog.segments]
        with torch.inference_mode():
            return pipeline(
                torch.as_tensor(x0, dtype=torch.float32).to(self.device),
                torch.as_tensor(cond, dtype=torch.float32).to(self.device),
                bounds,
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
