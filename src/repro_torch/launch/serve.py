"""Serving entry point: batched prefill, then decode, with a KV cache or a
recurrent state.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
        --epitome kernel-q3 --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-72b \\
        --epitome kernel-q3 --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
        --plan plan_legal.json --smoke --device cpu     # a '<arch>-smoke' plan
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-72b \\
        --epitome kernel-q3 --smoke --device cpu --engine --page-size 16 \\
        --prefill-chunk 16 --decode-block 4             # and through the engine
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch phi3.5-moe-42b-a6.6b --epitome kernel-q3 --smoke --device cpu \\
        --engine --decode-block 4                       # a MoE FFN
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch jamba-1.5-large-398b --epitome kernel-q3 --smoke --device cpu \\
        --engine --decode-block 4                       # Mamba, attention, MoE
    PYTHONPATH=src torchrun --standalone --nproc-per-node 8 \
        -m repro_torch.launch.serve --arch rwkv6-7b --epitome kernel-q3 --smoke \
        --device cpu --mesh 2,4                         # 8 gloo ranks, sharded

(counterpart of ``repro.launch.serve``).  It serves rwkv6-7b, the six
attention architectures with the dense FFN (qwen2-72b, qwen1.5-110b,
gemma2-2b, deepseek-67b, musicgen-large, internvl2-76b; the last two take
token ids here, their embedding inputs through ``models.lm`` directly),
the two with the MoE FFN (phi3.5-moe-42b-a6.6b, grok-1-314b), and
jamba-1.5-large-398b (Mamba layers with one attention layer in eight, the
dense and the MoE FFN in turn).  At full size grok-1 and jamba need more
than one card for their MoE FFNs (the serving specs keep the experts whole
on every rank); on one card they serve as ``--smoke``, and jamba also without its MoE FFNs
(``get_config(..., ffn_pattern=("dense", "none") * 4)``, as ``chip_smoke.py``
phase 14 serves it at full width and depth).  Parameters are drawn from
``--seed`` on the serving device and, for a kernel x quant variant such as
``kernel-q3``, prepacked once into int8 codes, so every forward feeds the
fused kernel stored codes.  Greedy decoding follows the reference token for
token: prefill, argmax, then max_new_tokens - 1 decode steps.  Sampled
decoding (``--temperature`` > 0) draws from a ``torch.Generator`` seeded
from ``--seed``; its bits cannot match the reference's gumbel draws from a
JAX key, so only greedy tokens are comparable across the two packages.
``--mesh D,M`` serves on a (D, M) mesh (``launch.mesh``; under
``torchrun`` for more than one rank), the parameters laid out by
placement; every rank computes every row, rank 0 prints.
``--engine`` also serves every prompt through the continuous-batching
``launch.engine.EpimEngine`` (one request per prompt: ``--page-size``,
``--kv-pages``, ``--prefill-chunk``, ``--decode-block``) and reports its
TTFT, steps and pages, and for greedy decoding whether its tokens equal the
one-shot batch's.
"""
from __future__ import annotations

import argparse
import time
import warnings
from typing import Optional

import torch

from ..models import lm
from ..models.common import get_mesh, set_mesh


def _select(logits: torch.Tensor, temperature: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """(B, vocab) logits -> (B, 1) int32 tokens: argmax when temperature is
    0, else one draw from softmax(logits / temperature) by the exponential
    race argmax(p / E), E ~ Exp(1) from ``generator`` (what
    ``torch.multinomial`` draws one sample by, without its host-side check
    of the probabilities: nothing here waits for the device)."""
    if temperature > 0:
        probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
        race = torch.empty_like(probs).exponential_(generator=generator)
        tok = torch.argmax(probs / race, dim=-1)
    else:
        tok = torch.argmax(logits, dim=-1)
    return tok.to(torch.int32)[:, None]


def generate(params, cfg, prompts: torch.Tensor, max_len: int, gen: int,
             temperature: float = 0.0, generator: Optional[torch.Generator] = None):
    """prompts: (B, P) int.  Returns (tokens (B, gen) int32, final state).
    ``max_len`` (at least P + gen - 1) sizes the attention layers' KV
    caches (unused by the recurrent kinds);
    ``generator`` draws the sampled tokens (on the prompts' device).  On an
    installed mesh the decode state is laid out by ``lm.state_specs``."""
    B, P = prompts.shape
    if max_len < P + gen - 1:
        raise ValueError(f"max_len {max_len} holds no KV cache row for a decode step: "
                         f"{P} prompt tokens and {gen} generated need {P + gen - 1}")
    with torch.no_grad():
        state = lm.init_decode_state(cfg, B, max_len, device=prompts.device,
                                     mesh=get_mesh())
        logits, state = lm.prefill(params, prompts, state, cfg)
        tok = _select(logits[:, -1], temperature, generator)
        toks = [tok]
        for i in range(gen - 1):
            logits, state = lm.decode_step(params, state, tok, P + i, cfg)
            tok = _select(logits[:, -1], temperature, generator)
            toks.append(tok)
    return torch.cat(toks, dim=1), state


def build_model(arch: str, epitome: str, smoke: bool, seed: int, device="cuda",
                plan=None, mesh=None):
    """(cfg, params) as the CLI serves them: drawn from ``seed`` on
    ``device`` and prepacked when a layer runs the fused int8 kernel.
    ``plan`` (an EpitomePlan or plan JSON path; arch '<arch>-smoke' with
    ``smoke``) sets the per-layer specs, bits and modes.  With ``mesh``
    the parameters are laid out on it by placement (every rank draws the
    same weights from ``seed`` and keeps its blocks)."""
    from ..configs import get_config, get_smoke_config
    cfg = (get_smoke_config(arch, epitome, plan=plan) if smoke
           else get_config(arch, epitome, plan=plan))
    gen = torch.Generator(device=device).manual_seed(seed)
    params = lm.init_params(gen, cfg, device)
    if lm.needs_prepack(cfg):
        params = lm.prepack_params(params, cfg, mesh=mesh)
    elif mesh is not None:
        params = lm.shard_params(params, cfg, mesh)
    return cfg, params


DEFAULT_REQUESTS, DEFAULT_NEW_TOKENS = 4, 16


def _resolve_deprecated(args, old: str, new: str) -> None:
    """An old flag still works but warns; the new flag wins when both are
    given."""
    old_v, new_v = getattr(args, old), getattr(args, new)
    if old_v is not None:
        warnings.warn(f"--{old.replace('_', '-')} is deprecated; use "
                      f"--{new.replace('_', '-')} (see launch.engine.Request)",
                      DeprecationWarning, stacklevel=2)
        if new_v is None:
            setattr(args, new, old_v)


def parse_args(argv=None) -> argparse.Namespace:
    """``build_parser``'s flags with the deprecated aliases resolved
    (--batch into --requests, --gen into --max-new-tokens) and the
    defaults filled in."""
    args = build_parser().parse_args(argv)
    _resolve_deprecated(args, "batch", "requests")
    _resolve_deprecated(args, "gen", "max_new_tokens")
    if args.requests is None:
        args.requests = DEFAULT_REQUESTS
    if args.max_new_tokens is None:
        args.max_new_tokens = DEFAULT_NEW_TOKENS
    return args


def build_parser() -> argparse.ArgumentParser:
    """Flags mirror EngineConfig / Request fields; --batch and --gen are
    deprecated aliases kept for old scripts."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="rwkv6-7b",
                    help="rwkv6-7b, qwen2-72b, qwen1.5-110b, gemma2-2b, deepseek-67b, "
                         "musicgen-large, internvl2-76b, phi3.5-moe-42b-a6.6b, "
                         "grok-1-314b or jamba-1.5-large-398b")
    ap.add_argument("--epitome", default="off")
    ap.add_argument("--plan", default="",
                    help="EpitomePlan JSON driving per-layer epitome "
                         "specs/bits/mode (arch '<arch>-smoke' with --smoke)")
    ap.add_argument("--mesh", default="",
                    help="'DATA,MODEL' mesh (e.g. 2,4 under torchrun, 1,1 on one card) to "
                         "serve on, parameters laid out by placement; default: the running "
                         "world (one device when there is no process group)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=None,
                    help=f"number of prompts to serve (default {DEFAULT_REQUESTS})")
    ap.add_argument("--batch", type=int, default=None, help="deprecated alias of --requests")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new-tokens", type=int, default=None,
                    help=f"tokens to generate a request (default {DEFAULT_NEW_TOKENS})")
    ap.add_argument("--gen", type=int, default=None,
                    help="deprecated alias of --max-new-tokens")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 samples every generated token")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--engine", action="store_true",
                    help="also serve the prompts through the continuous-batching "
                         "EpimEngine (one request per prompt) and report TTFT, "
                         "steps, pages and agreement")
    ap.add_argument("--page-size", type=int, default=16,
                    help="engine KV page size in tokens (0 = dense per-slot rows)")
    ap.add_argument("--kv-pages", type=int, default=0,
                    help="engine KV pool pages (0 = capacity * pages per slot; "
                         "fewer oversubscribe and defer admissions)")
    ap.add_argument("--prefill-chunk", type=int, default=64,
                    help="engine prefill chunk in tokens, rounded up to the arch's "
                         "recurrence alignment (0 = whole-prompt prefill)")
    ap.add_argument("--decode-block", type=int, default=1,
                    help="decode micro-steps fused into one engine dispatch")
    return ap


def main(argv=None):
    from .mesh import destroy_world, resolve_mesh
    args = parse_args(argv)
    device = torch.device(args.device)
    plan = args.plan or None
    if plan is not None:
        from ..pim.plan import EpitomePlan
        plan = EpitomePlan.load(plan)
    mesh = resolve_mesh(args.mesh, plan, device)
    set_mesh(mesh)
    try:
        return _serve(args, device, plan, mesh)
    finally:
        if mesh is not None:
            destroy_world()


def _serve(args, device, plan, mesh):
    """Every rank serves the same prompts; rank 0 prints."""
    from .mesh import describe, say
    cfg, params = build_model(args.arch, args.epitome, args.smoke, args.seed, device,
                              plan=plan, mesh=mesh if args.mesh else None)
    # the mesh that actually runs (a requested mesh is clamped to the world)
    say(f"[serve] mesh: {describe(mesh)}")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab, (args.requests, args.prompt_len),
                            generator=gen, device=device)
    max_len = args.prompt_len + args.max_new_tokens + 1
    t0 = time.perf_counter()
    toks, _ = generate(params, cfg, prompts, max_len, args.max_new_tokens,
                       temperature=args.temperature, generator=gen)
    toks = toks.cpu()          # waits for the device
    dt = time.perf_counter() - t0
    say(f"[serve] {args.arch} epitome={args.plan or args.epitome}"
          f"{' (prepacked)' if lm.needs_prepack(cfg) else ''} on {device}: generated "
          f"{tuple(toks.shape)} in {dt:.2f}s "
          f"({args.requests * args.max_new_tokens / dt:.1f} tok/s)")
    say("[serve] sample:", toks[0, :16].tolist())
    if args.engine:
        serve_engine(args, cfg, params, prompts, max_len, toks, say)
    return toks


def serve_engine(args, cfg, params, prompts: torch.Tensor, max_len: int,
                 toks: torch.Tensor, say=print) -> None:
    """Serve every prompt through the engine (one request each, ``--seed``
    for the sampled ones) and print its line; greedy tokens are compared
    with the one-shot batch's ``toks``."""
    from .engine import EpimEngine, Request
    engine = EpimEngine(cfg, params, capacity=len(prompts), max_len=max_len,
                        page_size=args.page_size, kv_pages=args.kv_pages,
                        prefill_chunk=args.prefill_chunk,
                        decode_block=args.decode_block, device=prompts.device)
    for row in prompts.tolist():
        engine.submit(Request(prompt=row, max_new_tokens=args.max_new_tokens,
                              temperature=args.temperature, seed=args.seed))
    comps = engine.drain()
    ttfts = sorted(c.ttft_s for c in comps)
    st = engine.stats
    line = (f"[serve] engine: completed={len(comps)} "
            f"p50_ttft={ttfts[len(ttfts) // 2] * 1e3:.1f}ms "
            f"steps={st['decode_steps']} micro_steps={st['decode_micro_steps']} "
            f"prefill_chunks={st['prefill_chunks']} "
            f"pages_hwm={st['pages_hwm']}/{st['pages_total']}")
    if args.temperature == 0.0:
        same = all(tuple(toks[i].tolist()) == c.tokens for i, c in enumerate(comps))
        line += f" bit_identical={same}"
    say(line)


if __name__ == "__main__":
    main()
