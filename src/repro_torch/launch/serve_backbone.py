"""Batched serving entry point: posterior-mean model, prefill + decode loop.

The port of ``repro/launch/serve_backbone.py``, with its flags plus
``--device`` (the card unless ``--device cpu``):

    PYTHONPATH=src python -m repro_torch.launch.serve_backbone --arch zamba2-7b \\
        --batch 8 --prompt-len 64 --gen 32 --full

Without ``--full`` it serves the reduced config (2 layers, f32). Weights
and variational parameters are random, drawn from seed 0; so are the
stub patch embeddings a vision config (qwen2-vl-2b) prefixes to each
prompt, whose tokens count in the cache's length, and the stub frame
embeddings (``encoder_seq_len`` of them) an encoder-decoder config
(whisper-base) encodes once in the prefill. Greedy
decoding (``--temperature 0``, the default) is deterministic; sampling
draws from a torch generator (not JAX's threefry stream).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import generator, resolve_device
from repro_torch.launch import steps as S
from repro_torch.models.backbone import transformer as T
from repro_torch.models.backbone.config import ArchConfig

SEED = 0  # weights, prompt and sampling stream (the JAX CLI's PRNGKey(0))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class ServeRun:
    """What one :func:`serve` call produced, and the state to go on decoding."""

    cfg: ArchConfig
    tokens: torch.Tensor  # (batch, gen) generated ids
    logits: torch.Tensor  # the last step's (batch, 1, vocab) logits
    prefill_s: float
    decode_s: float  # gen - 1 decode steps
    state: dict  # theta, eta_G, eta_L, cache, last token, prompt, prefill and decode steps


def serve(cfg: ArchConfig, *, batch: int, prompt_len: int, gen: int, silos: int,
          device: torch.device, temperature: float = 0.0) -> ServeRun:
    """Random weights from seed 0, one prefill of a random prompt (after
    ``cfg.num_vision_tokens`` random f32 patch embeddings where the config
    has a vision prefix; with (B, ``encoder_seq_len``, D) random f32 frames
    for an encoder-decoder), then ``gen - 1`` decode steps, timed on the
    host clock (each phase ends in a device synchronize)."""
    if batch % silos:
        raise ValueError(f"batch {batch} must be a multiple of silos {silos}")
    g = generator((SEED, 0), device)
    theta = T.init_params(g, cfg)
    eta_G = S.init_eta_G(g, cfg)
    eta_L = S.init_eta_L(g, cfg, silos)
    max_len = prompt_len + gen + cfg.num_vision_tokens
    prefill = S.make_serve_prefill(cfg, silos, max_len=max_len)
    decode = S.make_serve_decode(cfg, silos)
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=g,
                                      device=device)}
    if cfg.is_encoder_decoder:
        prompt["frames"] = torch.randn((batch, cfg.encoder_seq_len, cfg.d_model), generator=g,
                                       device=device)
    if cfg.num_vision_tokens:
        prompt["vision"] = torch.randn((batch, cfg.num_vision_tokens, cfg.d_model),
                                       generator=g, device=device)
    sample_gen = generator((SEED, 1), device)

    def sample(logits):
        if temperature <= 0:
            return torch.argmax(logits[:, -1], dim=-1)
        probs = torch.softmax(logits[:, -1].float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=sample_gen)[:, 0]

    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = prefill(theta, eta_G, eta_L, prompt)
        _sync(device)
        prefill_s = time.perf_counter() - t0
        tok = sample(logits)
        out = [tok]
        t0 = time.perf_counter()
        for _ in range(gen - 1):
            logits, cache = decode(theta, eta_G, eta_L, tok[:, None], cache)
            tok = sample(logits)
            out.append(tok)
        _sync(device)
        decode_s = time.perf_counter() - t0
    state = dict(theta=theta, eta_G=eta_G, eta_L=eta_L, cache=cache, tok=tok, prompt=prompt,
                 prefill=prefill, decode=decode)
    return ServeRun(cfg, torch.stack(out, dim=1), logits, prefill_s, decode_s, state)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--silos", type=int, default=4)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    run = serve(cfg, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
                silos=args.silos, device=device, temperature=args.temperature)
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len}: "
          f"prefill {run.prefill_s*1e3:.1f} ms "
          f"({args.batch*args.prompt_len/run.prefill_s:.0f} tok/s)")
    print(f"decode {args.gen-1} steps: {run.decode_s*1e3:.1f} ms "
          f"({args.batch*(args.gen-1)/max(run.decode_s, 1e-9):.0f} tok/s)")
    print("generated token ids (first request):", run.tokens[0][:16].tolist())
    return run.tokens


if __name__ == "__main__":
    main()
