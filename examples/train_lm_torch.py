"""Train a (reduced) LM architecture of the port on the synthetic token
stream: data pipeline -> train step (microbatching, remat, clipping,
optimizer) -> loss curve. The counterpart of examples/train_lm.py, on the
CUDA card unless ``--device cpu``.

    PYTHONPATH=src python examples/train_lm_torch.py --arch llama3.2-1b --steps 60
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --arch zamba2-1.2b --steps 10

The batch must be a multiple of the config's ``microbatches`` (deepseek-v3
splits into 16): the step refuses another size, naming both numbers.
"""
import argparse
import time

import torch

from repro_torch.configs import ARCH_NAMES, reduced_config
from repro_torch.data import TokenStream
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_lm_train_step
from repro_torch.models.lm import LM
from repro_torch.models.spec import tree_leaves
from repro_torch.optim import make_optimizer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=ARCH_NAMES)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the parameters' and memory's generators")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = reduced_config(args.arch)
    lm = LM(cfg, device=device)

    def gen(offset: int) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(args.seed + offset)

    params = lm.init_params(gen(0))
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    print(f"{args.arch} (reduced): {n_params/1e6:.1f}M params, "
          f"optimizer={cfg.optimizer}")

    opt = make_optimizer(cfg.optimizer, lr=3e-3)
    opt_state = opt.init(params)
    step = make_lm_train_step(lm, opt)
    stream = TokenStream(cfg.vocab, args.batch, args.seq, seed=0)

    mem = None
    if cfg.family in ("vlm", "encdec"):
        t = cfg.frontend_tokens or 16
        mem = (torch.randn((args.batch, t, cfg.d_model), generator=gen(1),
                           device=device) * 0.05).to(torch.bfloat16)

    t0 = time.time()
    for i in range(args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in next(stream).items()}
        if mem is not None:
            batch["memory"] = mem
        params, opt_state, m = step(params, opt_state, batch)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(m['loss']):.4f}  "
                  f"gnorm {float(m['grad_norm']):.3f}  "
                  f"({time.time()-t0:.1f}s)")
    print("loss should decrease from ~ln(vocab) as the model memorizes the "
          "Zipf/markov stream")


if __name__ == "__main__":
    main()
