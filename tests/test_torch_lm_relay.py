"""The port's LM prefix relay (``repro_torch.serving.lm_relay``) against
the JAX package on the CPU, in fp32 at reduced size (2-layer
``make_reduced(qwen3-4b)``; large and small from two seeds, carried across
by ``lm_params_from_jax``).

Tokens are compared exactly, and each greedy choice is held to its top-2
margin: at every decoded position the margin of the port's logits must
exceed ten times the largest difference between the two frameworks' fp32
logits there (the factor covers cached against teacher-forced logits), so
equal tokens are not luck and a tie would be reported as a tie.  A
traced relay's spans and Chrome trace JSON equal the reference's.
``sequence_logprob`` within 1e-5 relative.  The plan IR (``compile_plan``)
must give the reference's node order, groups and select metadata.
"""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import make_reduced as jmake_reduced
from repro.core import program as jprog
from repro.models import transformer as jtr
from repro.serving import lm_relay as jlr
from repro.serving.arms import dag_action_space
from repro.serving.obs import SpanTracer as JSpanTracer
from repro.serving.obs import to_chrome_trace as jto_chrome_trace
from repro.training.data import DataConfig as JDataConfig
from repro.training.data import TokenPipeline as JTokenPipeline
from repro_torch import configs
from repro_torch.core import program as prog
from repro_torch.models import transformer as tr
from repro_torch.serving import lm_relay
from repro_torch.serving.obs import (SpanTracer, to_chrome_trace,
                                     validate_chrome_trace)
from repro_torch.training.checkpoint import lm_params_from_jax
from repro_torch.training.data import DataConfig, TokenPipeline

torch.set_num_threads(1)

JCFG = jmake_reduced(jconfigs.get_config("qwen3-4b")).replace(n_layers=2)
CFG = configs.make_reduced(configs.get_config("qwen3-4b")).replace(n_layers=2)
S, TOTAL = 3, 6
MARGIN_FACTOR = 10.0


def _port(params) -> tr.LM:
    model = tr.init_model(CFG, torch.Generator().manual_seed(0), "cpu")
    model.load_state_dict(lm_params_from_jax(
        jax.tree.map(np.asarray, params), CFG))
    return model


@pytest.fixture(scope="module")
def relay():
    """Both packages' relay at s = 3 of 6 new tokens on a (2, 4) prompt,
    run once for the module."""
    jl, js = (jtr.init_model(jax.random.PRNGKey(k), JCFG) for k in (0, 1))
    prompt = np.random.default_rng(0).integers(0, CFG.vocab_size, (2, 4))
    prompt = prompt.astype(np.int32)
    ref_seq, ref_info = jlr.relay_decode(jl, JCFG, js, JCFG,
                                         jnp.asarray(prompt), S, TOTAL)
    large, small = _port(jl), _port(js)
    seq, info = lm_relay.relay_decode(large, CFG, small, CFG, prompt, S,
                                      TOTAL, device="cpu")
    return dict(jl=jl, js=js, large=large, small=small, prompt=prompt,
                ref_seq=np.asarray(ref_seq), ref_info=ref_info,
                seq=seq, info=info)


def _check_margins(model, params, seq: np.ndarray, first: int,
                   last: int) -> None:
    """The top-2 margin of the port's logits that chose tokens [first,
    last) of ``seq`` against the frameworks' logit difference there."""
    logits = tr.model_fwd(model, CFG, {"tokens": torch.from_numpy(seq)})
    ref, _, _ = jtr.model_fwd(params, JCFG, {"tokens": jnp.asarray(seq)})
    window = slice(first - 1, last - 1)
    out = logits[:, window, :CFG.vocab_size]
    diff = np.abs(out.numpy() - np.asarray(ref)[:, window, :CFG.vocab_size])
    top2 = torch.topk(out, 2).values
    margin = (top2[..., 0] - top2[..., 1]).numpy()
    ties = np.argwhere(margin <= MARGIN_FACTOR * diff.max(-1))
    assert ties.size == 0, (f"top-2 tie at (row, step) {ties.tolist()}: "
                            f"margins {margin.tolist()}")


def test_relay_decode_tokens_and_info_equal_reference(relay):
    seq = relay["seq"].numpy()
    p = relay["prompt"].shape[1]
    _check_margins(relay["large"], relay["jl"], seq, p, p + S)
    _check_margins(relay["small"], relay["js"], seq, p + S, p + TOTAL)
    np.testing.assert_array_equal(seq, relay["ref_seq"])
    assert relay["seq"].dtype == torch.int32 and seq.shape == (2, 4 + TOTAL)
    ref_info = dict(relay["ref_info"])
    assert relay["info"] == ref_info
    assert relay["info"]["transfer_bytes"] == 2 * (4 + S) * 4


def test_large_only_program_is_greedy_decode(relay):
    """s == total: one segment, no handoff, the large model's greedy
    decode, the same tokens as the reference's."""
    prompt = relay["prompt"]
    seq, info = lm_relay.relay_decode(relay["large"], CFG, relay["small"],
                                      CFG, prompt, TOTAL, TOTAL, device="cpu")
    alone = lm_relay.greedy_decode(relay["large"], CFG, prompt, TOTAL,
                                   device="cpu")
    assert torch.equal(seq, alone)
    assert info["node_tokens"] == {"n00": TOTAL}
    # the relay's large segment is the prefix of the large-only decode
    np.testing.assert_array_equal(seq[:, :4 + S].numpy(),
                                  relay["seq"][:, :4 + S].numpy())
    ref = jlr.greedy_decode(relay["jl"], JCFG, jnp.asarray(prompt), TOTAL)
    _check_margins(relay["large"], relay["jl"], seq.numpy(), 4, 4 + TOTAL)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(ref))


def test_sequence_logprob_matches_reference(relay):
    seq = relay["ref_seq"]
    ref = jlr.sequence_logprob(relay["jl"], JCFG, jnp.asarray(seq))
    out = lm_relay.sequence_logprob(relay["large"], CFG, seq, device="cpu")
    assert np.isfinite(out)
    assert abs(out - ref) <= 1e-5 * abs(ref)


def _to_port(graph):
    """The same plan built from the port's IR classes."""
    def seg(s):
        return None if s is None else prog.RelaySegment(**dataclasses.asdict(s))

    nodes = tuple(prog.GraphNode(**{**dataclasses.asdict(n),
                                    "segment": seg(n.segment)})
                  for n in graph.nodes)
    edges = tuple(prog.GraphEdge(e.src, e.dst, None if e.handoff is None
                                 else prog.Handoff(**dataclasses.asdict(e.handoff)))
                  for e in graph.edges)
    return prog.RelayGraph(graph.family, nodes, edges)


@pytest.mark.parametrize("arm", [a for a in dag_action_space()
                                 if isinstance(a.program, jprog.RelayGraph)],
                         ids=lambda a: a.label)
def test_compile_plan_equals_reference(arm):
    """Branching plans of the reference's DAG arms, declared in shuffled
    order, compile to the reference's order, groups, chain flag and
    select metadata."""
    ref_graph = arm.program
    shuffled = dataclasses.replace(ref_graph, nodes=ref_graph.nodes[::-1],
                                   edges=ref_graph.edges[::-1])
    ref = jprog.compile_plan(ref_graph)
    out = prog.compile_plan(_to_port(shuffled))
    assert out.order == ref.order and out.groups == ref.groups
    assert (out.source, out.sink, out.is_chain) == (ref.source, ref.sink,
                                                    ref.is_chain)
    assert {k: dataclasses.asdict(v) for k, v in out.selects.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref.selects.items()}
    assert out.graph.shape_key() == ref_graph.shape_key()


def test_lm_program_plan_equals_reference():
    for s, total in ((4, 10), (6, 6)):
        out, ref = lm_relay.lm_program(s, total), jlr.lm_program(s, total)
        assert out.shape_key() == ref.shape_key()
        assert [dataclasses.asdict(x) for x in out.segments] == \
            [dataclasses.asdict(x) for x in ref.segments]
        plan = prog.compile_plan(prog.as_graph(out))
        assert plan.order == jprog.compile_plan(jprog.as_graph(ref)).order
    with pytest.raises(ValueError, match="0 < s <= total"):
        lm_relay.lm_program(0, 4)


def test_execute_lm_program_rejects_join_nodes():
    ens = next(a.program for a in dag_action_space()
               if isinstance(a.program, jprog.RelayGraph)
               and any(n.kind == jprog.MERGE_NODE for n in a.program.nodes))
    with pytest.raises(ValueError, match="token-space"):
        lm_relay.execute_lm_program(_to_port(ens), {}, {},
                                    np.zeros((1, 2), np.int32), device="cpu")


def test_traced_relay_equals_reference(relay):
    """The tracer checks of the reference's
    ``test_relay_decode_parity_with_standalone_path`` on the port: a traced
    relay gives the untraced tokens and the reference's, the reference's
    spans (``as_dict``) and its Chrome trace JSON; the spans tile the
    logical clock of one second per token."""
    tracer, ref_tracer = SpanTracer(), JSpanTracer()
    seq, info = lm_relay.relay_decode(relay["large"], CFG, relay["small"],
                                      CFG, relay["prompt"], S, TOTAL,
                                      tracer=tracer, rid=7, device="cpu")
    ref_seq, _ = jlr.relay_decode(relay["jl"], JCFG, relay["js"], JCFG,
                                  jnp.asarray(relay["prompt"]), S, TOTAL,
                                  tracer=ref_tracer, rid=7)
    assert torch.equal(seq, relay["seq"]) and info == relay["info"]
    np.testing.assert_array_equal(seq.numpy(), np.asarray(ref_seq))
    assert [s.as_dict() for s in tracer.spans()] == \
        [s.as_dict() for s in ref_tracer.spans()]
    t = tracer.requests[7]
    assert t.complete and t.t_total == t.attributed_s() == float(TOTAL)
    assert [s.name for s in t.spans if s.kind == "segment"] == ["n00", "n01"]
    hops = [s for s in t.spans if s.kind == "hop"]
    assert [h.meta["bytes"] for h in hops] == [info["transfer_bytes"]]
    trace = to_chrome_trace(tracer)
    assert validate_chrome_trace(trace) == []
    assert json.dumps(trace) == json.dumps(jto_chrome_trace(ref_tracer))


def test_token_pipeline_equals_reference():
    for cfg in (dict(vocab_size=151936, seq_len=64, global_batch=8),
                dict(vocab_size=512, seq_len=9, global_batch=4, seed=3)):
        for host in (0, 1):
            out = TokenPipeline(DataConfig(**cfg), host, 2)
            ref = JTokenPipeline(JDataConfig(**cfg), host, 2)
            for step in (0, 999):
                for a, b in zip(out.batch(step), ref.batch(step)):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)


def test_entry_points_need_cuda_unless_told_cpu(relay):
    if torch.cuda.is_available():
        pytest.skip("checks the default device where CUDA is absent")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_relay.relay_decode(relay["large"], CFG, relay["small"], CFG,
                              relay["prompt"], S, TOTAL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_relay.sequence_logprob(relay["large"], CFG, relay["ref_seq"])
