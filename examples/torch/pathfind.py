"""DeepFlow pathfinding on the PyTorch port -- the paper's §9 workflow end
to end, on the batched pathfinding engine:

1. sweep a design space (tech nodes x HBM gens x meshes) in one batched
   evaluation and read off the Pareto frontier,
2. co-optimize parallelism strategy + hardware budgets with the batched
   multi-start SOE,
3. emit the sharding plan the runtime would use on the production mesh.

Runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch/pathfind.py [--device cpu]
        [--tilings 12] [--steps 10]

The same flows are scriptable via the CLI:

    PYTHONPATH=src python -m repro_torch.pathfind sweep \\
        --arch qwen3-moe-30b-a3b --cell train_4k --mesh 16x16 \\
        --logic N7,N3 --hbm HBM2E,HBM3
"""

import argparse

from repro_torch.configs.base import SHAPE_CELLS, get_config
from repro_torch.core import lmgraph, pathfinder, planner, soe, techlib
from repro_torch.core.roofline import PPEConfig

ARCH = "qwen3-moe-30b-a3b"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--tilings", type=int, default=12)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    ppe = PPEConfig(n_tilings=args.tilings)
    cfg = get_config(ARCH)
    cell = SHAPE_CELLS["train_4k"]
    g = lmgraph.build_graph(cfg, cell)
    print(f"=== pathfind: {cfg.name} x {cell.name} "
          f"({g.total_flops():.2e} flops/graph-template) on "
          f"{args.device} ===")

    print("-- 1. batched design-space sweep (tech x memory x mesh) --")
    result = pathfinder.sweep(
        [ARCH], ["train_4k"], [(16, 16), (8, 8)],
        logic_nodes=("N7", "N3"), hbms=("HBM2E", "HBM3"),
        nets=("IB-NDR-X8",), ppe=ppe, device=args.device)
    for p in sorted(result.points, key=lambda p: p.time_s)[:4]:
        print(f"   {p.logic:>3}/{p.hbm:<5} mesh "
              f"{'x'.join(map(str, p.mesh)):>5} {p.strategy.name:<18} "
              f"{p.time_s * 1e3:8.1f} ms/iter")
    frontier = result.pareto(objectives=("time_s", "devices"))
    print(f"   Pareto(time, devices): {len(frontier)} of "
          f"{len(result.points)} points")
    for p in sorted(frontier, key=lambda p: p.devices):
        print(f"     d{p.devices:<4} {p.logic}/{p.hbm} "
              f"-> {p.time_s * 1e3:.1f} ms")
    stats = pathfinder.cache_stats()
    print(f"   prediction cache: {stats['hits']} hits / "
          f"{stats['misses']} misses")

    print("-- 2. batched multi-start SOE co-optimization on N7 (256 dev) --")
    tech = techlib.make_tech_config("N7", "HBM2E", "IB-NDR-X8")
    res = soe.co_optimize(tech, g, n_devices=256, search_arch=True,
                          cfg=soe.SOEConfig(steps=args.steps, starts=2),
                          ppe=ppe, device=args.device)
    print(f"   best strategy {res.strategy.name}: {res.time_s * 1e3:.1f} "
          f"ms; core area frac -> "
          f"{float(res.budgets.area_frac['core']):.2f} "
          f"({res.n_queries} CrossFlow queries)")

    print("-- 3. runtime sharding plan on the production mesh --")
    plan = planner.plan(cfg, cell, (16, 16), ("data", "model"),
                        device=args.device)
    print(f"   strategy {plan.strategy.name} predicted "
          f"{plan.predicted_step_s * 1e3:.1f} ms/step")
    for axis, rule in plan.rules:
        print(f"   {axis:10s} -> {rule}")


if __name__ == "__main__":
    main()
