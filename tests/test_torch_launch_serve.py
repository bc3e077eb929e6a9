"""The port's launcher (`repro_torch.launch.serve`) on the CPU: every mode
runs with `--device cpu`; the LM mode's continuation equals a direct
`prefill` + `decode_step` on the same seed; the topology mode's printed
engine stats equal those of the JAX package's launcher (`repro.launch.serve`)
for the same arguments, key for key.
"""
import contextlib
import io
import json

import pytest
import torch

from repro.launch import serve as jserve
from repro_torch import configs
from repro_torch.models import lm
from repro_torch.launch import serve

LM_ARGS = ["--arch", "llama3.2-1b", "--smoke", "--batch", "2",
           "--prompt-len", "8", "--gen", "4", "--seed", "3"]


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = main(argv)
    return ret, out.getvalue()


def _json_line(text, prefix):
    lines = [ln for ln in text.splitlines() if ln.startswith(prefix)]
    assert len(lines) == 1, text
    return json.loads(lines[0][len(prefix):])


def test_lm_mode_continuation_is_direct_prefill_and_decode():
    tps, text = _run(serve.main, LM_ARGS + ["--device", "cpu"])
    assert tps > 0 and "[serve] sample continuation ids:" in text
    stats = _json_line(text, "[serve] lm stats:")
    assert stats["prefills"] == serve.LM_RUNS + 1
    assert len(stats["prefill_ms"]) == len(stats["decode_ms_per_step"]) \
        == serve.LM_RUNS
    assert stats["tokens_per_s"] == pytest.approx(tps)

    cfg = configs.get("llama3.2-1b").smoke_config()
    gen = torch.Generator().manual_seed(3)
    params = lm.init_params(gen, cfg)
    prompts = torch.randint(0, cfg.vocab, (2, 8), generator=gen)
    logits, cache = lm.prefill(params, prompts, cfg, max_len=12)
    toks = [logits.argmax(-1)]
    for _ in range(3):
        logits, cache = lm.decode_step(params, cache, toks[-1][:, None], cfg)
        toks.append(logits.argmax(-1))
    assert stats["continuation"] == torch.stack(toks, 1).tolist()


def test_lm_mode_needs_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(LM_ARGS)
    # the MoE archs serve since the MoE FFN is ported; a GNN id loads its
    # config and the LM mode refuses it up front, naming its family
    tps, text = _run(serve.main, ["--arch", "deepseek-moe-16b", "--smoke",
                                  "--device", "cpu"])
    assert tps > 0 and '"arch": "deepseek-moe-16b-smoke"' in text
    with pytest.raises(ValueError, match="family 'gnn'"):
        serve.main(["--arch", "gat-cora", "--smoke", "--device", "cpu"])


def test_topology_stats_equal_jax_launchers():
    argv = ["--topology", "--smoke", "--requests", "6", "--repeat", "2"]
    rate, text = _run(serve.main, argv + ["--device", "cpu"])
    _, jtext = _run(jserve.main, argv)
    prefix = "[serve-topology] engine stats:"
    got, want = _json_line(text, prefix), _json_line(jtext, prefix)
    assert got == want
    assert rate > 0 and got["requests"] == 12 and got["cache_hits"] == 1


def test_async_mode():
    rate, text = _run(serve.main, ["--topology", "--async", "--smoke",
                                   "--requests", "8", "--device", "cpu"])
    stats = _json_line(text, "[serve-async] engine stats:")
    trace = _json_line(text, "[serve-async] replay trace:")
    assert rate > 0 and stats["requests"] == 8 and stats["completed"] == 8
    assert stats["batches"] == (stats["flush_capacity"]
                                + stats["flush_deadline"]
                                + stats["flush_drain"] + stats["flush_retry"])
    assert len(trace["arrivals"]) == 8


def test_overload_mode():
    dropped, text = _run(serve.main, ["--topology", "--async", "--overload",
                                      "--smoke", "--requests", "16",
                                      "--device", "cpu"])
    stats = _json_line(text, "[serve-overload] engine stats:")
    assert dropped == stats["rejected"] + stats["shed"] > 0
    assert stats["completed"] + stats["failures"] + stats["shed"] \
        == stats["requests"]
    assert "parity held on all" in text
