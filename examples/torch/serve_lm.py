"""Batched serving on the PyTorch port across three model families: dense
(qwen), hybrid (recurrentgemma: RG-LRU state + local-attention ring
cache), and ssm (xlstm: matrix/scalar recurrent state).  Runs on the card
unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch/serve_lm.py [--device cpu]
        [--prompt-len 24] [--gen 8]
"""

import argparse

from repro_torch.launch.serve import serve


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=8)
    args = ap.parse_args(argv)
    for arch in ("qwen1.5-0.5b", "recurrentgemma-2b", "xlstm-125m"):
        out = serve(arch, batch=2, prompt_len=args.prompt_len, gen=args.gen,
                    use_reduced=True, device=args.device)
        print(f"{arch:20s} strategy={out['plan']:18s} "
              f"prefill={out['prefill_s']:.2f}s "
              f"decode={out['decode_s']:.2f}s "
              f"({out['tok_per_s']:.1f} tok/s)")
        print(f"{'':20s} sample: {out['tokens'][0][:8].tolist()}")


if __name__ == "__main__":
    main()
