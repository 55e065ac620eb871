"""Technology components library (DeepFlow paper §4.1, Table 1).

A system is composed of primitive components: compute units (MCUs), on-chip
memory banks, off-chip memory devices, and network links. Each carries the
physical/technology parameters the micro-architecture generator engine (AGE)
needs to derive throughput / bandwidth / capacity under area, power and
perimeter budgets.

Units used throughout `repro_torch.core`:
  area        mm^2            energy      J (joule) / pJ where noted
  power       W               frequency   Hz
  bandwidth   bytes/s         capacity    bytes
  time        s               flops       FLOP (not FLOPS)

The library ships the standard entries used by the paper's case studies
(logic nodes N12..N1, HBM2/2e/3/HBM4, InfiniBand NDR/XDR/GDR) plus two
calibration entries used by this reproduction: ``tpu_v5e`` (the dry-run /
roofline target) and ``cpu_host`` (the only *real* hardware in this container,
used for measured-vs-predicted validation, paper §8).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

# ---------------------------------------------------------------------------
# Component descriptions (paper Table 1)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ComputeTech:
    """A minimal compute unit (MCU): e.g. one MXU systolic array / tensor core."""

    name: str
    tech_node: str                  # e.g. "N7"
    nominal_area_mm2: float         # area of one MCU
    nominal_voltage: float          # V
    threshold_voltage: float        # V
    minimum_voltage: float          # V
    maximum_voltage: float          # V
    nominal_frequency: float        # Hz
    nominal_flops_per_cycle: float  # per MCU per cycle (MACs*2)
    energy_per_flop: float          # J at nominal voltage/frequency
    systolic_dims: tuple = (128, 128)  # (N_x, N_y) — used by the dataflow model
    max_utilization: float = 0.85   # derate (paper §4.2.1: V100 fill/drain ~85%)
    die_cost_usd: float = 4000.0    # per-device compute die cost (TCO capex)

    @property
    def nominal_flop_rate(self) -> float:
        return self.nominal_flops_per_cycle * self.nominal_frequency

    @property
    def nominal_power(self) -> float:
        return self.nominal_flop_rate * self.energy_per_flop


@dataclasses.dataclass(frozen=True)
class OnChipMemTech:
    """On-chip memory modelled at bank granularity (paper §4.1.2)."""

    name: str
    technology: str                 # "SRAM" etc.
    bank_capacity_bytes: float
    area_per_bit_mm2: float
    area_overhead_frac: float       # periphery overhead on top of cell area
    controller_area_per_bank_mm2: float
    controller_power_per_bank_w: float
    dynamic_energy_per_bit: float   # J/bit
    static_power_per_bit: float     # W/bit
    latency_s: float
    # crossbar connecting banks to the clients at the next level up
    xbar_area_per_port_mm2: float = 1e-4
    xbar_energy_per_bit: float = 5e-14

    @property
    def bank_area_mm2(self) -> float:
        return (self.bank_capacity_bytes * 8.0 * self.area_per_bit_mm2
                * (1.0 + self.area_overhead_frac))


@dataclasses.dataclass(frozen=True)
class OffChipMemTech:
    """Off-chip memory modelled at device granularity, e.g. one HBM stack."""

    name: str
    technology: str
    device_capacity_bytes: float
    device_area_mm2: float          # footprint on interposer/substrate
    device_bw_bytes: float          # peak BW per device at nominal frequency
    controller_io_area_mm2: float   # on-die controller+PHY area per device
    dynamic_energy_per_bit: float   # J/bit
    static_power_per_device_w: float
    links_per_device: int
    links_per_mm: float             # escape density along die perimeter
    nominal_voltage: float
    minimum_voltage: float
    threshold_voltage: float
    nominal_frequency: float        # per-link signalling rate
    access_latency_s: float
    cost_usd_per_gb: float = 10.0   # memory cost (TCO capex)

    @property
    def bytes_per_cycle_per_device(self) -> float:
        return self.device_bw_bytes / self.nominal_frequency


@dataclasses.dataclass(frozen=True)
class NetworkTech:
    """Intra- or inter-package link technology (paper §4.1.3)."""

    name: str
    scope: str                      # "intra_package" | "inter_package"
    nominal_bw_per_link_bytes: float
    nominal_energy_per_bit: float   # J/bit
    area_per_link_mm2: float
    links_per_mm: float             # perimeter escape density
    link_latency_s: float
    nominal_voltage: float
    minimum_voltage: float
    threshold_voltage: float
    nominal_frequency: float


@dataclasses.dataclass(frozen=True)
class TechConfig:
    """A full technology configuration: one entry per component category."""

    name: str
    compute: ComputeTech
    l2: OnChipMemTech               # second-level on-chip (TPU: CMEM / big shared)
    l1: OnChipMemTech               # first-level on-chip (TPU: VMEM)
    l0: OnChipMemTech               # register file / vregs
    dram: OffChipMemTech
    net_intra: NetworkTech
    net_inter: NetworkTech

    def memory_levels(self):
        """Off-chip -> on-chip order used by the hierarchical roofline (L=3 on-chip)."""
        return [self.l0, self.l1, self.l2]


# ---------------------------------------------------------------------------
# Voltage/frequency scaling (paper §4.4: "standard V-F-P scaling methodology")
#
# `freq_at_voltage` / `dynamic_energy_scale` take tensors as well as floats,
# so autograd flows through them when a continuous DVFS knob rides along
# the SOE budget vector.  `solve_voltage_for_power` is the host-side
# inverse (bisection) used when a refined operating point is re-scored
# discretely.
# ---------------------------------------------------------------------------


def freq_at_voltage(v, tech_vnom: float, tech_fnom: float, vth: float):
    """Alpha-power-law (alpha=1) frequency model: f ∝ (V - Vth).

    Python floats in -> float out; a tensor in -> a tensor out.
    """
    headroom = v - vth
    denom = max(tech_vnom - vth, 1e-9)
    if isinstance(headroom, (int, float)):
        return tech_fnom * max(headroom, 0.0) / denom
    return tech_fnom * headroom.clamp_min(0.0) / denom


def dynamic_energy_scale(v: float, vnom: float) -> float:
    """Dynamic energy per op scales with V^2."""
    return (v / vnom) ** 2


def solve_voltage_for_power(power_budget: float, nominal_power: float,
                            vnom: float, vth: float, vmin: float) -> float:
    """Find operating voltage V <= Vnom such that dynamic power fits the budget.

    P(V) = P_nom * (V/Vnom)^2 * (V-Vth)/(Vnom-Vth)   (energy*V^2, rate*(V-Vth))
    Solved by bisection; clamps to [vmin, vnom].
    """
    if nominal_power <= power_budget:
        return vnom

    def p(v: float) -> float:
        return (nominal_power * dynamic_energy_scale(v, vnom)
                * max(v - vth, 0.0) / max(vnom - vth, 1e-9))

    lo, hi = vmin, vnom
    if p(lo) >= power_budget:
        return vmin
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if p(mid) > power_budget:
            hi = mid
        else:
            lo = mid
    return lo


# ---------------------------------------------------------------------------
# Standard library entries
# ---------------------------------------------------------------------------

# Logic nodes N12..N1. Paper §9: area scales 1.8x and power 1.3x per node
# (iso-performance). We anchor N12 at a V100-class tensor-core MCU.
_LOGIC_NODES = ["N12", "N7", "N5", "N3", "N2", "N1.5", "N1"]
_N12_MCU_AREA = 0.80          # mm^2 per MCU (tensor-core-bundle scale anchor)
_N12_E_FLOP = 1.10e-12        # J/flop fp16 at N12 (~V100-class efficiency)
_AREA_SCALE_PER_NODE = 1.8
_POWER_SCALE_PER_NODE = 1.3

# Per-tech cost table ($/token TCO objective, repro_torch.core.objectives):
# wafer cost roughly doubles every two nodes while usable area shrinks,
# so the per-die cost climbs steeply toward the leading edge.
_LOGIC_DIE_USD: Dict[str, float] = {
    "N12": 2500.0, "N7": 5000.0, "N5": 8000.0, "N3": 12000.0,
    "N2": 17000.0, "N1.5": 23000.0, "N1": 30000.0,
}
_HBM_USD_PER_GB: Dict[str, float] = {
    "HBM2": 8.0, "HBM2E": 10.0, "HBM3": 12.0, "HBM4": 16.0,
}


def _logic(node: str) -> ComputeTech:
    i = _LOGIC_NODES.index(node)
    return ComputeTech(
        name=f"mcu_{node.lower()}",
        tech_node=node,
        nominal_area_mm2=_N12_MCU_AREA / (_AREA_SCALE_PER_NODE ** i),
        nominal_voltage=0.80,
        threshold_voltage=0.30,
        minimum_voltage=0.55,
        maximum_voltage=0.95,
        nominal_frequency=1.40e9,
        nominal_flops_per_cycle=512.0,      # 256 MACs/cycle
        energy_per_flop=_N12_E_FLOP / (_POWER_SCALE_PER_NODE ** i),
        systolic_dims=(16, 16),
        max_utilization=0.85,
        die_cost_usd=_LOGIC_DIE_USD[node],
    )


def _sram(node: str, bank_kib: float = 64.0) -> OnChipMemTech:
    i = _LOGIC_NODES.index(node)
    area_scale = _AREA_SCALE_PER_NODE ** (i * 0.75)   # SRAM scales worse than logic
    power_scale = _POWER_SCALE_PER_NODE ** i
    return OnChipMemTech(
        name=f"sram_{node.lower()}_{int(bank_kib)}k",
        technology="SRAM",
        bank_capacity_bytes=bank_kib * 1024,
        area_per_bit_mm2=3.0e-7 / area_scale,
        area_overhead_frac=0.30,
        controller_area_per_bank_mm2=2.0e-3 / area_scale,
        controller_power_per_bank_w=2.0e-3 / power_scale,
        dynamic_energy_per_bit=8.0e-14 / power_scale,
        static_power_per_bit=2.0e-11 / power_scale,
        latency_s=2.0e-9,
    )


def _regfile(node: str) -> OnChipMemTech:
    i = _LOGIC_NODES.index(node)
    area_scale = _AREA_SCALE_PER_NODE ** (i * 0.75)
    power_scale = _POWER_SCALE_PER_NODE ** i
    return OnChipMemTech(
        name=f"rf_{node.lower()}",
        technology="SRAM-RF",
        bank_capacity_bytes=4.0 * 1024,
        area_per_bit_mm2=8.0e-7 / area_scale,
        area_overhead_frac=0.20,
        controller_area_per_bank_mm2=5.0e-4 / area_scale,
        controller_power_per_bank_w=5.0e-4 / power_scale,
        dynamic_energy_per_bit=2.0e-14 / power_scale,
        static_power_per_bit=1.0e-11 / power_scale,
        latency_s=0.5e-9,
    )


_HBM_GENS: Dict[str, float] = {     # per-stack bandwidth (paper §9 figures are
    "HBM2": 0.45e12,                # ~2-4 stacks: HBM2 system => ~1 TB/s, etc.)
    "HBM2E": 0.90e12,
    "HBM3": 1.20e12,
    "HBM4": 1.65e12,
}
_HBM_EPB: Dict[str, float] = {      # J/bit improves with generation
    "HBM2": 4.0e-12,
    "HBM2E": 3.3e-12,
    "HBM3": 2.6e-12,
    "HBM4": 2.0e-12,
}


def _hbm(gen: str) -> OffChipMemTech:
    bw = _HBM_GENS[gen]
    return OffChipMemTech(
        name=gen.lower(),
        technology=gen,
        device_capacity_bytes=16.0 * 2**30,
        device_area_mm2=110.0,
        device_bw_bytes=bw,
        controller_io_area_mm2=12.0,
        dynamic_energy_per_bit=_HBM_EPB[gen],
        static_power_per_device_w=2.5,
        links_per_device=1024,
        links_per_mm=80.0,
        nominal_voltage=1.1,
        minimum_voltage=0.8,
        threshold_voltage=0.35,
        nominal_frequency=bw / 1024 * 8,   # per-link bit rate
        access_latency_s=120e-9,
        cost_usd_per_gb=_HBM_USD_PER_GB[gen],
    )


_NET_GENS: Dict[str, float] = {
    # inter-node network technologies (paper §9; GDR figure text uses 400 GB/s)
    "IB-NDR-X8": 100e9,
    "IB-XDR-X8": 200e9,
    "IB-GDR-X8": 400e9,
}
_NET_EPB: Dict[str, float] = {      # J/bit improves with generation — else
    "IB-NDR-X8": 5.0e-12,           # the AGE power budget caps XDR == GDR
    "IB-XDR-X8": 3.3e-12,
    "IB-GDR-X8": 2.2e-12,
}


def _inter_net(gen: str) -> NetworkTech:
    bw = _NET_GENS[gen]
    n_links = 8
    return NetworkTech(
        name=gen.lower(),
        scope="inter_package",
        nominal_bw_per_link_bytes=bw / n_links,
        nominal_energy_per_bit=_NET_EPB[gen],
        area_per_link_mm2=0.9,
        links_per_mm=0.5,
        link_latency_s=1.0e-6,
        nominal_voltage=0.9,
        minimum_voltage=0.6,
        threshold_voltage=0.3,
        nominal_frequency=bw / n_links * 8,
    )


def _intra_net(bw_per_link: float = 2e12 / 8) -> NetworkTech:
    # 2.5D-substrate / on-package links (paper §9.3 assumes 2 TB/s intra-package)
    return NetworkTech(
        name="substrate_2p5d",
        scope="intra_package",
        nominal_bw_per_link_bytes=bw_per_link,
        nominal_energy_per_bit=0.6e-12,
        area_per_link_mm2=0.05,
        links_per_mm=10.0,
        link_latency_s=20e-9,
        nominal_voltage=0.8,
        minimum_voltage=0.55,
        threshold_voltage=0.3,
        nominal_frequency=bw_per_link * 8,
    )


# --- TPU v5e calibration entry (the dry-run / roofline target) --------------
# Peak 197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI (per the brief).

def _tpu_v5e_compute() -> ComputeTech:
    # 4 MXUs of 128x128 @ ~0.94 GHz * 2 flops => ~197 TF/s per chip when N=4.
    f = 1.5e9
    flops_per_cycle = 128 * 128 * 2.0
    return ComputeTech(
        name="mxu_v5e",
        tech_node="N5",
        nominal_area_mm2=30.0,
        nominal_voltage=0.75,
        threshold_voltage=0.30,
        minimum_voltage=0.55,
        maximum_voltage=0.90,
        nominal_frequency=f,
        nominal_flops_per_cycle=flops_per_cycle,
        energy_per_flop=0.35e-12,
        systolic_dims=(128, 128),
        max_utilization=0.85,
        die_cost_usd=6000.0,
    )


def _tpu_v5e_hbm() -> OffChipMemTech:
    return OffChipMemTech(
        name="hbm2_v5e",
        technology="HBM2",
        device_capacity_bytes=8.0 * 2**30,
        device_area_mm2=100.0,
        device_bw_bytes=409.5e9,            # 2 stacks => 819 GB/s
        controller_io_area_mm2=10.0,
        dynamic_energy_per_bit=4.0e-12,
        static_power_per_device_w=2.0,
        links_per_device=1024,
        links_per_mm=80.0,
        nominal_voltage=1.1,
        minimum_voltage=0.8,
        threshold_voltage=0.35,
        nominal_frequency=409.5e9 / 1024 * 8,
        access_latency_s=120e-9,
        cost_usd_per_gb=8.0,
    )


def _tpu_v5e_ici() -> NetworkTech:
    return NetworkTech(
        name="ici_v5e",
        scope="inter_package",
        nominal_bw_per_link_bytes=50e9,     # per link per direction
        nominal_energy_per_bit=1.0e-12,
        area_per_link_mm2=0.4,
        links_per_mm=1.0,
        link_latency_s=0.5e-6,
        nominal_voltage=0.9,
        minimum_voltage=0.6,
        threshold_voltage=0.3,
        nominal_frequency=50e9 * 8,
    )


def _cpu_host_compute() -> ComputeTech:
    """Calibration entry for THIS container's CPU (measured-vs-predicted, §8).

    Calibrated post-hoc by `benchmarks/fig6_gemm_validation.py --calibrate`
    which measures peak achieved GEMM flops; defaults here are a reasonable
    single-core AVX2 guess (re-written by calibration).
    """
    f = 3.0e9
    return ComputeTech(
        name="cpu_host",
        tech_node="N7",
        nominal_area_mm2=8.0,
        nominal_voltage=1.0,
        threshold_voltage=0.35,
        minimum_voltage=0.7,
        maximum_voltage=1.2,
        nominal_frequency=f,
        nominal_flops_per_cycle=32.0,       # AVX2 FMA f32: 2*2*8
        energy_per_flop=5.0e-12,
        systolic_dims=(4, 8),
        max_utilization=0.90,
        die_cost_usd=1500.0,
    )


def _cpu_host_dram() -> OffChipMemTech:
    return OffChipMemTech(
        name="ddr_host",
        technology="DDR4",
        device_capacity_bytes=16.0 * 2**30,
        device_area_mm2=100.0,
        device_bw_bytes=12e9,
        controller_io_area_mm2=8.0,
        dynamic_energy_per_bit=12e-12,
        static_power_per_device_w=1.5,
        links_per_device=64,
        links_per_mm=10.0,
        nominal_voltage=1.2,
        minimum_voltage=1.0,
        threshold_voltage=0.4,
        nominal_frequency=12e9 / 64 * 8,
        access_latency_s=90e-9,
        cost_usd_per_gb=3.0,
    )


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


def make_tech_config(logic: str = "N7", hbm: str = "HBM2E",
                     inter_net: str = "IB-NDR-X8",
                     intra_bw: float = 2e12 / 8) -> TechConfig:
    """Compose a TechConfig from the standard library (paper case-study axes)."""
    return TechConfig(
        name=f"{logic}/{hbm}/{inter_net}",
        compute=_logic(logic),
        l2=_sram(logic, bank_kib=256.0),
        l1=_sram(logic, bank_kib=64.0),
        l0=_regfile(logic),
        dram=_hbm(hbm),
        net_intra=_intra_net(intra_bw),
        net_inter=_inter_net(inter_net),
    )


def tech_from_dict(d: Dict) -> TechConfig:
    """Inverse of ``dataclasses.asdict(tech)``: rebuild a TechConfig from
    its nested dict form (how a TechConfig crosses between packages)."""
    compute = dict(d["compute"])
    compute["systolic_dims"] = tuple(compute["systolic_dims"])
    return TechConfig(
        name=d["name"], compute=ComputeTech(**compute),
        l2=OnChipMemTech(**d["l2"]), l1=OnChipMemTech(**d["l1"]),
        l0=OnChipMemTech(**d["l0"]), dram=OffChipMemTech(**d["dram"]),
        net_intra=NetworkTech(**d["net_intra"]),
        net_inter=NetworkTech(**d["net_inter"]))


def tpu_v5e_tech() -> TechConfig:
    n = "N5"
    return TechConfig(
        name="tpu_v5e",
        compute=_tpu_v5e_compute(),
        l2=_sram(n, bank_kib=512.0),
        l1=_sram(n, bank_kib=128.0),
        l0=_regfile(n),
        dram=_tpu_v5e_hbm(),
        net_intra=_intra_net(),
        net_inter=_tpu_v5e_ici(),
    )


def cpu_host_tech() -> TechConfig:
    n = "N7"
    return TechConfig(
        name="cpu_host",
        compute=_cpu_host_compute(),
        l2=_sram(n, bank_kib=1024.0),
        l1=_sram(n, bank_kib=64.0),
        l0=_regfile(n),
        dram=_cpu_host_dram(),
        net_intra=_intra_net(16e9),
        net_inter=_inter_net("IB-NDR-X8"),
    )


# ---------------------------------------------------------------------------
# Energy/cost coefficients for the objective layer (repro_torch.core.objectives)
#
# Both helpers are plain arithmetic over the TechConfig and two MicroArch
# scalars, so autograd flows through them when cooptimize's DVFS knobs
# arrive as tensors.
# ---------------------------------------------------------------------------

# static (leakage) compute power as a fraction of nominal dynamic power
LEAKAGE_FRAC = 0.15


def device_cost_usd(tech: TechConfig, dram_capacity_bytes):
    """Per-device capex: compute die plus memory at $/GB."""
    return (tech.compute.die_cost_usd
            + tech.dram.cost_usd_per_gb * dram_capacity_bytes / 2**30)


def static_power_w(tech: TechConfig, dram_capacity_bytes,
                   compute_throughput):
    """Per-device static power: DRAM refresh/standby plus logic leakage."""
    n_dev = dram_capacity_bytes / tech.dram.device_capacity_bytes
    return (tech.dram.static_power_per_device_w * n_dev
            + LEAKAGE_FRAC * compute_throughput * tech.compute.energy_per_flop)


LOGIC_NODES = list(_LOGIC_NODES)
HBM_GENERATIONS = list(_HBM_GENS)
NETWORK_GENERATIONS = list(_NET_GENS)
