"""Parallelism strategy space (DeepFlow paper §3.3).

A strategy is written ``RC-{KP1}-{KP2}-d{DP}-p{LP}`` or ``CR-{KP1}-d{DP}-p{LP}``:

  * RC (Row-Column / inner-product distributed GEMM): the first matrix is
    sharded KP1 ways across rows (M) and the second KP2 ways across columns
    (N). Each worker owns an (M/KP1, N/KP2) output block and the full
    contraction dim; activations are all-gathered along the torus dims.
  * CR (Column-Row / outer-product): the first matrix is cut KP1 ways across
    columns (K) and the second across rows (K); each worker produces a full
    (M, N) partial product that must be all-reduced.
  * DP: number of model replicas / data shards (ring all-reduce of grads).
  * LP: number of pipeline stages.
  * EP (extension, not in the paper's notation): expert parallelism for MoE
    archs — routed experts sharded EP ways, all-to-all dispatch.
  * SP (extension): sequence sharding for long-context cells.

Total device count = KP1 * KP2 * DP * LP (EP/SP reuse the KP axis).
"""

from __future__ import annotations

import dataclasses
import itertools
import re
from typing import Iterator, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Strategy:
    kind: str = "RC"        # "RC" | "CR"
    kp1: int = 1
    kp2: int = 1            # ignored for CR
    dp: int = 1
    lp: int = 1
    ep: int = 1             # expert parallel degree (<= kp1*kp2)
    sp: int = 1             # sequence parallel degree (<= kp1*kp2)

    def __post_init__(self):
        assert self.kind in ("RC", "CR"), self.kind
        if self.kind == "CR":
            object.__setattr__(self, "kp2", 1)

    @property
    def kp(self) -> int:
        return self.kp1 * self.kp2

    @property
    def devices(self) -> int:
        return self.kp1 * self.kp2 * self.dp * self.lp

    @property
    def name(self) -> str:
        if self.kind == "RC":
            s = f"RC-{self.kp1}-{self.kp2}-d{self.dp}-p{self.lp}"
        else:
            s = f"CR-{self.kp1}-d{self.dp}-p{self.lp}"
        if self.ep > 1:
            s += f"-e{self.ep}"
        if self.sp > 1:
            s += f"-s{self.sp}"
        return s

    @staticmethod
    def parse(text: str) -> "Strategy":
        """Parse the paper's notation, e.g. 'RC-4-2-d3-p2' or 'CR-8-d64-p1'."""
        m = re.fullmatch(
            r"(RC|CR)-(\d+)(?:-(\d+))?-d(\d+)-p(\d+)(?:-e(\d+))?(?:-s(\d+))?",
            text.strip())
        if not m:
            raise ValueError(f"bad strategy spec: {text!r}")
        kind, kp1, kp2, dp, lp, ep, sp = m.groups()
        if kind == "RC" and kp2 is None:
            raise ValueError(f"RC needs two kernel-parallel degrees: {text!r}")
        return Strategy(kind=kind, kp1=int(kp1),
                        kp2=int(kp2 or 1), dp=int(dp), lp=int(lp),
                        ep=int(ep or 1), sp=int(sp or 1))


def _divisors(x: int) -> List[int]:
    out = [d for d in range(1, x + 1) if x % d == 0]
    return out


def enumerate_strategies(n_devices: int,
                         max_lp: int = 8,
                         kinds: Tuple[str, ...] = ("RC", "CR"),
                         allow_ep: bool = False,
                         pow2_only: bool = True) -> Iterator[Strategy]:
    """All factorizations KP1*KP2*DP*LP == n_devices (paper's search space)."""
    degrees = [d for d in _divisors(n_devices)
               if not pow2_only or (d & (d - 1)) == 0]
    for lp in degrees:
        if lp > max_lp:
            continue
        rem1 = n_devices // lp
        for dp in _divisors(rem1):
            if pow2_only and dp & (dp - 1):
                continue
            kp = rem1 // dp
            if "CR" in kinds:
                yield Strategy("CR", kp1=kp, dp=dp, lp=lp)
            if "RC" in kinds:
                for kp1 in _divisors(kp):
                    if pow2_only and kp1 & (kp1 - 1):
                        continue
                    s = Strategy("RC", kp1=kp1, kp2=kp // kp1, dp=dp, lp=lp)
                    yield s
                    if allow_ep and kp > 1:
                        yield dataclasses.replace(s, ep=kp)


def mesh_factorization(strategy: Strategy,
                       mesh_shape: Tuple[int, ...]) -> Optional[dict]:
    """Check a strategy fits a physical mesh; return the axis assignment.

    The runtime mesh exposes ('pod', 'data', 'model') (or ('data','model')).
    DP*LP must cover pod*data and KP must equal the model axis (the planner
    in repro_torch.core.planner relies on this invariant).
    """
    total = 1
    for s in mesh_shape:
        total *= s
    if strategy.devices != total:
        return None
    model = mesh_shape[-1]
    if strategy.kp != model:
        return None
    return {"model": strategy.kp, "data_pipe": strategy.dp * strategy.lp}
