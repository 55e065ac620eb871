"""Quickstart on the PyTorch port: train a small qwen-family LM on the
synthetic pipeline and watch the loss descend, then decode a few tokens
from it.  Runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
        [--steps 60]
"""

import argparse

from repro_torch.launch.serve import serve
from repro_torch.launch.train import TrainConfig, train


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    print(f"=== quickstart: train a reduced qwen1.5 for {args.steps} steps "
          f"on {args.device} ===")
    tc = TrainConfig(arch="qwen1.5-0.5b", steps=args.steps, global_batch=8,
                     seq_len=64, mesh_shape=(1, 1), lr=1e-3,
                     warmup=max(args.steps // 6, 1), use_reduced_config=True,
                     log_every=10, device=args.device)
    out = train(tc)
    first, last = out["history"][0], out["final_loss"]
    print(f"loss: {first:.3f} -> {last:.3f} "
          f"({(1 - last / first) * 100:.0f}% down)")
    assert last < first, "training must descend on the structured stream"

    print("=== quickstart: decode from the same family ===")
    s = serve("qwen1.5-0.5b", batch=2, prompt_len=16, gen=8,
              use_reduced=True, device=args.device)
    print(f"decoded {s['tokens'].shape} tokens at {s['tok_per_s']:.1f} "
          f"tok/s under strategy {s['plan']}")


if __name__ == "__main__":
    main()
