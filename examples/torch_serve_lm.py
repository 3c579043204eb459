"""Batched LM serving on the PyTorch/CUDA port: prefill + greedy decode
over every cache kind.

The port of ``examples/serve_lm.py``: reduced configs of four cache
families — standard KV (deepseek), rolling SWA ring (danube), pure SSM
state (mamba2), hybrid (jamba) — on the card, printing tokens/s for
batched greedy generation.

  PYTHONPATH=src python examples/torch_serve_lm.py [--max-new 16] [--device cpu]
"""

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.models.lm import build_model
from repro_torch.serve.serve_step import greedy_generate

ARCHS = ["deepseek-7b", "h2o-danube-1.8b", "mamba2-370m", "jamba-v0.1-52b"]


def run(device="cuda", max_new=16, batch=4, prompt_len=32):
    """The reference's run on ``device``; returns per architecture the
    generated shape, the seconds and the tokens/s of the timed call."""
    device = resolve_device(device)
    out = {}
    for name in ARCHS:
        cfg = get_config(name).reduced()
        model = build_model(cfg, device)
        params = model.init(0)
        toks = torch.zeros((batch, prompt_len), dtype=torch.int32,
                           device=device)
        b = {"tokens": toks}
        greedy_generate(model, cfg, params, b, max_new=2, device=device)
        t0 = time.perf_counter()
        gen = greedy_generate(model, cfg, params, b, max_new=max_new,
                              device=device).cpu()
        dt = time.perf_counter() - t0
        rate = batch * max_new / dt
        print(f"{name:18s} generated {tuple(gen.shape)} in {dt:5.2f}s "
              f"({rate:7.1f} tok/s, reduced config)")
        out[name] = {"shape": list(gen.shape), "seconds": dt,
                     "tokens_per_s": rate}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch operations)")
    args = ap.parse_args(argv)
    return run(args.device, max_new=args.max_new, batch=args.batch,
               prompt_len=args.prompt_len)


if __name__ == "__main__":
    main()
