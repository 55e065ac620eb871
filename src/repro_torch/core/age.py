"""Micro-Architecture Generator Engine (AGE) — DeepFlow paper §4.

Given (technology config, architecture template, area/power/perimeter budget
breakdown), derive the micro-architectural parameters consumed by the
performance prediction engine:

  * compute throughput (paper eq. 1, voltage-frequency scaled),
  * per-level on-chip memory capacity + bandwidth (eqs. 2-3, crossbar +
    controller overheads included),
  * main-memory capacity + bandwidth (eq. 4),
  * intra- and inter-package network bandwidth.

All arithmetic is float32 torch, so autograd flows from every MicroArch
leaf back to the budget fractions (the Search-and-Optimization Engine's
exact gradients).  Python floats stay Python floats until a tensor op
meets them, as in the reference (`repro_torch.core.tensors`).  Set
``discrete=True`` to apply floors (reporting mode).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import techlib
from repro_torch.core.techlib import TechConfig
from repro_torch.core.tensors import F32, as_f32, clip, div, maximum, minimum

# Component keys, in the order used by budget vectors (SOE optimizes this
# flat vector; keep the order stable).
COMPONENTS = ("core", "l2", "l1", "l0", "dram", "net_intra", "net_inter")
# Perimeter is only consumed by off-die interfaces.
PERIM_COMPONENTS = ("dram", "net_intra", "net_inter")


@dataclasses.dataclass(frozen=True)
class Budgets:
    """Hardware resource allocation (paper §4.3, Fig. 4)."""

    node_area_mm2: float = 1230.0       # package/substrate budget
    proc_chip_area_mm2: float = 815.0   # compute die budget
    power_w: float = 300.0
    # fractional breakdowns over COMPONENTS; need not sum exactly to 1
    area_frac: Dict[str, float] = dataclasses.field(default_factory=dict)
    power_frac: Dict[str, float] = dataclasses.field(default_factory=dict)
    perim_frac: Dict[str, float] = dataclasses.field(default_factory=dict)

    @staticmethod
    def default() -> "Budgets":
        return Budgets(
            area_frac={"core": 0.35, "l2": 0.14, "l1": 0.10, "l0": 0.20,
                       "dram": 0.05, "net_intra": 0.06, "net_inter": 0.10},
            power_frac={"core": 0.50, "l2": 0.12, "l1": 0.10, "l0": 0.08,
                        "dram": 0.12, "net_intra": 0.03, "net_inter": 0.05},
            perim_frac={"dram": 0.50, "net_intra": 0.20, "net_inter": 0.30},
        )

    def as_vector(self, device=None) -> torch.Tensor:
        """Flatten to the SOE parameter vector W = {A_i, P_i, R_i} (paper §7)."""
        a = [self.area_frac.get(c, 0.0) for c in COMPONENTS]
        p = [self.power_frac.get(c, 0.0) for c in COMPONENTS]
        r = [self.perim_frac.get(c, 0.0) for c in PERIM_COMPONENTS]
        return torch.tensor(a + p + r, dtype=F32,
                            device=resolve_device(device))

    @staticmethod
    def from_vector(w, like: "Budgets") -> "Budgets":
        n = len(COMPONENTS)
        a = {c: w[i] for i, c in enumerate(COMPONENTS)}
        p = {c: w[n + i] for i, c in enumerate(COMPONENTS)}
        r = {c: w[2 * n + i] for i, c in enumerate(PERIM_COMPONENTS)}
        return Budgets(node_area_mm2=like.node_area_mm2,
                       proc_chip_area_mm2=like.proc_chip_area_mm2,
                       power_w=like.power_w,
                       area_frac=a, power_frac=p, perim_frac=r)


# numeric leaves of a MicroArch, in field order (tuples hold one per level)
LEAF_FIELDS = ("n_mcu", "core_frequency", "compute_throughput",
               "mem_capacity", "mem_bw", "mem_latency", "dram_capacity",
               "dram_bw", "dram_latency", "net_intra_bw", "net_intra_links",
               "net_intra_latency", "net_inter_bw", "net_inter_links",
               "net_inter_latency")


@dataclasses.dataclass(frozen=True)
class MicroArch:
    """AGE output: the parameters the performance model consumes.

    Bandwidths are aggregate bytes/s per accelerator node; capacities bytes.
    Fields may be Python floats or 0-d float32 tensors on ``device``, the
    device every tensor of a prediction on this hardware lives on.
    """

    tech: TechConfig
    n_mcu: object
    core_frequency: object
    compute_throughput: object          # flops/s, after max_utilization derate
    mem_capacity: tuple                 # (L0, L1, L2) bytes
    mem_bw: tuple                       # (L0, L1, L2) bytes/s
    mem_latency: tuple                  # (L0, L1, L2) s
    dram_capacity: object
    dram_bw: object
    dram_latency: float
    net_intra_bw: object                # per-link effective bytes/s
    net_intra_links: object
    net_intra_latency: float
    net_inter_bw: object                # per-link effective bytes/s
    net_inter_links: object
    net_inter_latency: float
    device: torch.device = torch.device("cuda")

    def memory_hierarchy(self):
        """(capacity, bw, latency) per level, L0 (regs) .. L3 (DRAM)."""
        caps = list(self.mem_capacity) + [self.dram_capacity]
        bws = list(self.mem_bw) + [self.dram_bw]
        lats = list(self.mem_latency) + [self.dram_latency]
        return caps, bws, lats

    @staticmethod
    def from_numpy(d: Dict, device=None) -> "MicroArch":
        """Build from another package's MicroArch leaves: floats stay
        floats, numpy arrays become float32 tensors on ``device``; ``tech``
        is a TechConfig or its ``dataclasses.asdict`` form."""
        dev = resolve_device(device)

        def leaf(v):
            if isinstance(v, (tuple, list)):
                return tuple(leaf(x) for x in v)
            if isinstance(v, (np.ndarray, np.generic)):
                return torch.as_tensor(np.array(v, dtype=np.float32),
                                       device=dev)
            return float(v)

        tech = d["tech"]
        if not isinstance(tech, TechConfig):
            tech = techlib.tech_from_dict(tech)
        return MicroArch(tech=tech, device=dev,
                         **{f: leaf(d[f]) for f in LEAF_FIELDS})


def _smooth_floor(x, discrete: bool, dev):
    return torch.floor(as_f32(x, dev)) if discrete else x


def _power_limited_voltage(p_budget, p_nominal, vnom, vth, vmin, dev):
    """Differentiable fixed-point solve of P(V)=Pb (see techlib docstring).

    P(V) = Pnom * (V/Vnom)^2 * (V-Vth)/(Vnom-Vth); 20 unrolled iterations of
    V <- Vth + (Vnom-Vth) * (Pb/Pnom) * (Vnom/V)^2, clipped to [vmin, vnom].
    """
    ratio = clip(div(p_budget, maximum(p_nominal, 1e-12, dev)), 1e-6, 1.0,
                 dev)
    v = torch.tensor(vnom, dtype=F32, device=dev)
    for _ in range(20):
        v_new = vth + (vnom - vth) * ratio * div(vnom, maximum(v, 1e-6)) ** 2
        v = clip(v_new, vmin, vnom)
    return v


def _budget_device(budgets: Budgets, device):
    for frac in (budgets.area_frac, budgets.power_frac, budgets.perim_frac):
        for v in frac.values():
            if torch.is_tensor(v):
                return v.device
    return resolve_device(device)


def generate(tech: TechConfig, budgets: Budgets, discrete: bool = True,
             device=None) -> MicroArch:
    """Run the AGE (paper §4.4): budgets + tech -> micro-arch parameters.

    Runs on the device of a tensor budget vector, else on ``device``."""
    dev = _budget_device(budgets, device)
    af, pf, rf = budgets.area_frac, budgets.power_frac, budgets.perim_frac
    chip_area = budgets.proc_chip_area_mm2
    power = budgets.power_w
    perimeter = 4.0 * torch.sqrt(as_f32(chip_area, dev))

    # ---- Core (paper §4.4.1, eq. 1) ------------------------------------
    c = tech.compute
    a_core = af.get("core", 0.0) * chip_area
    p_core = pf.get("core", 0.0) * power
    n_mcu = _smooth_floor(div(a_core, c.nominal_area_mm2), discrete, dev)
    n_mcu = maximum(n_mcu, 1e-3, dev)
    p_nominal = n_mcu * c.nominal_power
    v_op = _power_limited_voltage(p_core, p_nominal, c.nominal_voltage,
                                  c.threshold_voltage, c.minimum_voltage, dev)
    f_op = div(c.nominal_frequency * (v_op - c.threshold_voltage),
               (c.nominal_voltage - c.threshold_voltage))
    # If even Vmin overflows the power budget, shed MCUs (paper: "reduce the
    # number of MCUs till we satisfy the total power budget").
    p_at_vmin = (n_mcu * c.nominal_power
                 * div(v_op, c.nominal_voltage) ** 2
                 * div(f_op, c.nominal_frequency))
    shed = clip(div(p_core, maximum(p_at_vmin, 1e-12)), 0.0, 1.0)
    n_eff = n_mcu * shed
    n_eff = _smooth_floor(n_eff, discrete, dev)
    n_eff = maximum(n_eff, 1e-3)
    throughput = (n_eff * c.nominal_flops_per_cycle * f_op
                  * c.max_utilization)                       # eq. 1 (+derate)

    # ---- On-chip memory levels (paper §4.4.2, eqs. 2-3) -----------------
    caps, bws, lats = [], [], []
    n_clients = n_eff     # crossbar ports scale with #MCUs (paper §9.1 insight)
    for name in ("l0", "l1", "l2"):
        m: techlib.OnChipMemTech = getattr(tech, name)
        a_m = af.get(name, 0.0) * chip_area
        p_m = pf.get(name, 0.0) * power
        per_bank = (m.bank_area_mm2 + m.controller_area_per_bank_mm2
                    + n_clients * m.xbar_area_per_port_mm2)
        n_banks = _smooth_floor(div(a_m, per_bank), discrete, dev)
        n_banks = maximum(n_banks, 1e-3)
        capacity = n_banks * m.bank_capacity_bytes
        p_static = (m.static_power_per_bit * capacity * 8.0
                    + n_banks * m.controller_power_per_bank_w)       # eq. 2
        p_dyn = maximum(p_m - p_static, 0.0)
        bw_bits = div(p_dyn, (m.dynamic_energy_per_bit
                              + m.xbar_energy_per_bit))
        bws.append(div(bw_bits, 8.0))                                 # eq. 3
        caps.append(capacity)
        lats.append(m.latency_s)

    # ---- Main memory (paper §4.4.3, eq. 4) ------------------------------
    d = tech.dram
    a_ctrl = af.get("dram", 0.0) * chip_area
    p_dram = pf.get("dram", 0.0) * power
    perim_links = rf.get("dram", 0.0) * perimeter * d.links_per_mm
    n_dev = minimum(
        minimum(div(budgets.node_area_mm2 - chip_area, d.device_area_mm2),
                div(a_ctrl, d.controller_io_area_mm2), dev),
        div(perim_links, d.links_per_device))                         # eq. 4
    n_dev = maximum(_smooth_floor(n_dev, discrete, dev), 1e-3)
    dram_capacity = n_dev * d.device_capacity_bytes
    bw_nom = n_dev * d.device_bw_bytes
    p_static_dram = n_dev * d.static_power_per_device_w
    p_dyn_dram = maximum(p_dram - p_static_dram, 0.0)
    dram_bw = minimum(bw_nom, div(p_dyn_dram, (d.dynamic_energy_per_bit
                                               * 8.0)))

    # ---- Networks (paper §4.4.4) ----------------------------------------
    def _net(n: techlib.NetworkTech, key: str):
        a_n = af.get(key, 0.0) * chip_area
        p_n = pf.get(key, 0.0) * power
        n_links = minimum(div(a_n, n.area_per_link_mm2),
                          rf.get(key, 0.0) * perimeter * n.links_per_mm)
        n_links = maximum(_smooth_floor(n_links, discrete, dev), 1e-3)
        bw_nom_total = n_links * n.nominal_bw_per_link_bytes
        bw_pow = div(p_n, (n.nominal_energy_per_bit * 8.0))
        bw_total = minimum(bw_nom_total, bw_pow, dev)
        return div(bw_total, n_links), n_links      # effective per-link BW

    intra_bw, intra_links = _net(tech.net_intra, "net_intra")
    inter_bw, inter_links = _net(tech.net_inter, "net_inter")

    return MicroArch(
        tech=tech,
        n_mcu=n_eff,
        core_frequency=f_op,
        compute_throughput=throughput,
        mem_capacity=tuple(caps),
        mem_bw=tuple(bws),
        mem_latency=tuple(lats),
        dram_capacity=dram_capacity,
        dram_bw=dram_bw,
        dram_latency=d.access_latency_s,
        net_intra_bw=intra_bw,
        net_intra_links=intra_links,
        net_intra_latency=tech.net_intra.link_latency_s,
        net_inter_bw=inter_bw,
        net_inter_links=inter_links,
        net_inter_latency=tech.net_inter.link_latency_s,
        device=dev,
    )


def fixed_microarch(tech: TechConfig, *, compute_flops: float, dram_bw: float,
                    dram_capacity: float, net_inter_bw: float,
                    net_inter_links: float = 4.0,
                    net_intra_bw: Optional[float] = None,
                    l2_bytes: float = 128 * 2**20, l2_bw: Optional[float] = None,
                    l1_bytes: float = 128 * 2**20, l1_bw: Optional[float] = None,
                    l0_bytes: float = 256 * 2**10, l0_bw: Optional[float] = None,
                    device=None) -> MicroArch:
    """Bypass the AGE with *known* hardware (TPU v5e, CPU host): used when we
    model existing silicon rather than explore hypothetical budgets.  The
    leaves are Python floats; ``device`` is where predictions on it run."""
    l2_bw = l2_bw if l2_bw is not None else dram_bw * 6.0
    l1_bw = l1_bw if l1_bw is not None else dram_bw * 24.0
    l0_bw = l0_bw if l0_bw is not None else compute_flops * 2.0  # regs feed MXU
    return MicroArch(
        tech=tech,
        n_mcu=4.0,
        core_frequency=tech.compute.nominal_frequency,
        compute_throughput=compute_flops * tech.compute.max_utilization,
        mem_capacity=(l0_bytes, l1_bytes, l2_bytes),
        mem_bw=(l0_bw, l1_bw, l2_bw),
        mem_latency=(0.5e-9, 5e-9, 15e-9),
        dram_capacity=dram_capacity,
        dram_bw=dram_bw,
        dram_latency=tech.dram.access_latency_s,
        net_intra_bw=net_intra_bw if net_intra_bw is not None else net_inter_bw,
        net_intra_links=4.0,
        net_intra_latency=tech.net_intra.link_latency_s,
        net_inter_bw=net_inter_bw,
        net_inter_links=net_inter_links,
        net_inter_latency=tech.net_inter.link_latency_s,
        device=resolve_device(device),
    )


def tpu_v5e_microarch(device=None) -> MicroArch:
    """The dry-run/roofline target: 197 TF bf16, 819 GB/s HBM, 50 GB/s ICI."""
    return fixed_microarch(
        techlib.tpu_v5e_tech(),
        compute_flops=197e12,
        dram_bw=819e9,
        dram_capacity=16.0 * 2**30,
        net_inter_bw=50e9,
        net_inter_links=4.0,
        l1_bytes=128 * 2**20,           # VMEM
        device=device,
    )


def cpu_host_microarch(compute_flops: float = 5.0e10,
                       dram_bw: float = 1.2e10, device=None) -> MicroArch:
    """Calibratable model of a CPU host (the reference's validation
    hardware); its numbers describe that host, not the card."""
    return fixed_microarch(
        techlib.cpu_host_tech(),
        compute_flops=compute_flops,
        dram_bw=dram_bw,
        dram_capacity=16.0 * 2**30,
        net_inter_bw=10e9,
        l2_bytes=32 * 2**20, l2_bw=dram_bw * 6,
        l1_bytes=1 * 2**20, l1_bw=dram_bw * 20,
        l0_bytes=64 * 2**10,
        device=device,
    )
