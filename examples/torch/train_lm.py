"""End-to-end training on the PyTorch port: a ~100M-param LM trained for
a few hundred steps with checkpoint/resume, the straggler watchdog and
int8 gradient compression -- the full production path at a small scale.
Runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch/train_lm.py --steps 300
    (40 steps by default; ~100M parameters on a CPU are slow but work:
    ``--device cpu --reduced --steps 2 --batch 2 --seq 16`` drives the
    same path on the smoke-scale qwen in seconds)
"""

import argparse
import dataclasses
import os
import sys
import tempfile
import types

from repro_torch.launch.train import TrainConfig, train


def build_100m():
    """~100M-param member of the qwen family (vocab-dominated)."""
    import repro_torch.configs.qwen1_5_0_5b as q
    return dataclasses.replace(
        q.CONFIG, name="qwen-100m", n_layers=6, d_model=512, n_heads=8,
        n_kv_heads=8, d_ff=1408, vocab_size=65536)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--reduced", action="store_true",
                    help="the smoke-scale qwen instead of the ~100M model")
    args = ap.parse_args(argv)

    cfg = build_100m()
    if args.reduced:
        from repro_torch.configs.base import reduced
        cfg = dataclasses.replace(reduced(cfg), name="qwen-100m-smoke")
    n = cfg.param_count()
    print(f"=== train_lm: {cfg.name} ({n / 1e6:.0f}M params) "
          f"for {args.steps} steps on {args.device} ===")
    # the config under a module name of its own: get_config finds it there
    mod = types.ModuleType("repro_torch.configs.qwen_100m")
    mod.CONFIG = cfg
    sys.modules["repro_torch.configs.qwen_100m"] = mod

    ckpt = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                         "repro_torch_train_lm_ckpt")
    tc = TrainConfig(arch="qwen_100m", steps=args.steps,
                     global_batch=args.batch, seq_len=args.seq,
                     mesh_shape=(1, 1), lr=6e-4,
                     warmup=min(20, max(args.steps // 2, 1)),
                     ckpt_dir=ckpt, ckpt_every=20, log_every=5,
                     grad_compression="int8", device=args.device)
    out = train(tc)
    h = out["history"]
    print(f"loss: {h[0]:.3f} -> {h[-1]:.3f}; checkpoints in {ckpt}; "
          f"stragglers flagged: {len(out['stragglers'])}")


if __name__ == "__main__":
    main()
