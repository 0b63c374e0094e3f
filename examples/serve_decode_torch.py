"""Batched-request LM serving on the port: prefill a batch of prompts, then
decode greedily with the per-arch KV/recurrent caches. Runs a reduced config
of any of the ten architectures, on the CUDA card unless ``--device cpu``.

    PYTHONPATH=src python examples/serve_decode_torch.py --device cpu --arch rwkv6-7b --tokens 24
    PYTHONPATH=src python examples/serve_decode_torch.py --arch deepseek-v2-lite-16b

Greedy decoding takes the argmax over the padded vocabulary, as the
reference CLI (examples/serve_decode.py) does, so it can emit a padded id.
"""
import argparse
import time

import torch

from repro_torch.configs import ARCH_NAMES, reduced_config
from repro_torch.device import resolve_device
from repro_torch.models.lm import LM


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=ARCH_NAMES)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = reduced_config(args.arch)
    lm = LM(cfg, device=device)

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(seed)

    params = lm.init_params(gen(0))
    mem = None
    if cfg.family in ("vlm", "encdec"):
        t = cfg.frontend_tokens or 16
        mem = (torch.randn((args.batch, t, cfg.d_model), generator=gen(1),
                           device=device) * 0.05).to(torch.bfloat16)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen(2), device=device)

    t0 = time.time()
    logits, caches = lm.prefill(params, prompts, args.max_seq, mem)
    _sync(device)
    print(f"prefill {args.batch}x{args.prompt_len}: {time.time()-t0:.2f}s")

    toks = logits.argmax(-1)[:, None]
    out = [toks]
    t0 = time.time()
    for i in range(args.tokens - 1):
        logits, caches = lm.decode_step(params, caches, toks,
                                        args.prompt_len + i, mem)
        toks = logits.argmax(-1)[:, None]
        out.append(toks)
    _sync(device)
    dt = time.time() - t0
    gen_ids = torch.cat(out, dim=1).cpu()
    print(f"decoded {args.tokens} tokens/seq in {dt:.2f}s "
          f"({args.tokens*args.batch/max(dt,1e-9):.1f} tok/s total)")
    for b in range(args.batch):
        print(f"  seq{b}: {gen_ids[b].tolist()}")


if __name__ == "__main__":
    main()
