"""Device hardware parameters for the CFN power model.

Paper sources:
  Table 1 (processing): RPi-4B (IoT), Intel i5-3427U (AF/MF), Xeon E5-2640 (CDC).
  Table 2 (networking): ONU AP (Wi-Fi), OLT, Metro router port, Metro switch,
  IP/WDM node.
  PUE: AF 1.25, MF 1.35, CDC 1.12, core 1.5, others 1.0 (paper §3).
  Idle-attribution share delta = 3% on shared high-capacity gear (paper §3,
  following [9]); access ONU APs are dedicated to the zone => full idle.

Assumptions not printed in the paper (recorded in DESIGN.md §2):
  * server counts per node (NS), LAN switch parameters inside processing nodes,
  * inter-VM bitrates (see vsr.py).
All power in W, network rates in Gbps for capacity / W-per-Gbps for energy,
processing in GFLOPS.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ProcessingHW:
    """One processing-node class (Table 1 + LAN assumptions)."""

    name: str
    max_w: float           # max power of one server (W)
    idle_w: float          # idle power of one server (W)
    cap_gflops: float      # capacity of one server (GFLOPS)
    n_servers: int         # servers deployed at the node (NS_p)
    pue: float             # PUE_p
    # LAN inside the node (switches/routers interconnecting the servers)
    lan_idle_w: float      # pi^{LAN}
    lan_eps_w_per_gbps: float   # EL_p
    lan_cap_gbps: float    # C^{LAN}
    lan_idle_share: float  # fraction of LAN idle attributed to this service

    @property
    def eps_w_per_gflops(self) -> float:
        """E_p = (max - idle) / capacity (Table 1 'Efficiency')."""
        return (self.max_w - self.idle_w) / self.cap_gflops


@dataclass(frozen=True)
class NetworkHW:
    """One network-node class (Table 2)."""

    name: str
    max_w: float
    idle_w: float
    cap_gbps: float
    pue: float
    idle_share: float      # delta: attributed fraction of idle power

    @property
    def eps_w_per_gbps(self) -> float:
        """epsilon_n = (max - idle) / capacity (Table 2 'Efficiency')."""
        return (self.max_w - self.idle_w) / self.cap_gbps


# ----------------------------------------------------------------------------
# Paper preset (Tables 1 & 2).
# ----------------------------------------------------------------------------

IOT_RPI4 = ProcessingHW(
    name="iot-rpi4", max_w=7.3, idle_w=2.56, cap_gflops=13.5, n_servers=1,
    pue=1.0, lan_idle_w=0.0, lan_eps_w_per_gbps=0.0, lan_cap_gbps=1.0,
    lan_idle_share=0.0)

AF_I5 = ProcessingHW(
    name="af-i5-3427u", max_w=37.2, idle_w=13.8, cap_gflops=34.5, n_servers=10,
    pue=1.25, lan_idle_w=15.0, lan_eps_w_per_gbps=0.05, lan_cap_gbps=128.0,
    lan_idle_share=1.0)

MF_I5 = ProcessingHW(
    name="mf-i5-3427u", max_w=37.2, idle_w=13.8, cap_gflops=34.5, n_servers=10,
    pue=1.35, lan_idle_w=15.0, lan_eps_w_per_gbps=0.05, lan_cap_gbps=128.0,
    lan_idle_share=1.0)

CDC_XEON = ProcessingHW(
    name="cdc-xeon-e5-2640", max_w=298.0, idle_w=58.7, cap_gflops=428.0,
    n_servers=128, pue=1.12, lan_idle_w=423.0, lan_eps_w_per_gbps=0.08,
    lan_cap_gbps=600.0, lan_idle_share=0.03)

ONU_AP = NetworkHW(name="onu-ap-wifi", max_w=15.0, idle_w=9.0, cap_gbps=10.0,
                   pue=1.0, idle_share=0.03)
OLT = NetworkHW(name="olt", max_w=1940.0, idle_w=60.0, cap_gbps=8600.0,
                pue=1.0, idle_share=0.03)
METRO_ROUTER = NetworkHW(name="metro-router-port", max_w=30.0, idle_w=27.0,
                         cap_gbps=40.0, pue=1.0, idle_share=0.03)
METRO_SWITCH = NetworkHW(name="metro-switch", max_w=470.0, idle_w=423.0,
                         cap_gbps=600.0, pue=1.0, idle_share=0.03)
IPWDM_NODE = NetworkHW(name="ip-wdm-node", max_w=878.0, idle_w=790.0,
                       cap_gbps=40.0, pue=1.5, idle_share=0.03)

# The paper (§2.1) attaches the AF node to the OLT "via low-capacity low end
# routers and switches" (and the MF analogously at the metro aggregation
# switch) but prints no power entries for them; we use datasheet-class figures
# for an enterprise edge router / 48-port GbE switch, FULLY attributed because
# they are dedicated to the fog deployment (unlike the shared OLT/metro/core
# gear at delta = 3%).  This is the calibration that reproduces the paper's
# observed behaviour: AF/MF are never selected and overflow at 20 VSRs spills
# to the CDC (DESIGN.md §2, assumption ii).
LOW_END_ROUTER = NetworkHW(name="low-end-router", max_w=75.0, idle_w=60.0,
                           cap_gbps=20.0, pue=1.0, idle_share=1.0)
LOW_END_SWITCH = NetworkHW(name="low-end-switch", max_w=100.0, idle_w=80.0,
                           cap_gbps=100.0, pue=1.0, idle_share=1.0)


# ----------------------------------------------------------------------------
# Datacenter-scale preset (beyond-paper extension): the same CFN abstraction
# with TPU-pod-class processing nodes, so the placement engine can schedule the
# assigned LM architectures (see vsr.from_architecture).  Values are public
# ballpark figures for a v5e-class chip (197 TFLOPS bf16, ~250 W board power)
# and DCN/WAN optics; they parameterize the model, they are not measurements.
# ----------------------------------------------------------------------------

EDGE_POD = ProcessingHW(
    name="edge-pod-8chip", max_w=8 * 250.0, idle_w=8 * 75.0,
    cap_gflops=8 * 197_000.0, n_servers=4, pue=1.1,
    lan_idle_w=150.0, lan_eps_w_per_gbps=0.02, lan_cap_gbps=1600.0,
    lan_idle_share=1.0)

FOG_POD = ProcessingHW(
    name="fog-pod-32chip", max_w=32 * 250.0, idle_w=32 * 75.0,
    cap_gflops=32 * 197_000.0, n_servers=8, pue=1.25,
    lan_idle_w=600.0, lan_eps_w_per_gbps=0.02, lan_cap_gbps=6400.0,
    lan_idle_share=1.0)

CLOUD_POD = ProcessingHW(
    name="cloud-pod-256chip", max_w=256 * 250.0, idle_w=256 * 75.0,
    cap_gflops=256 * 197_000.0, n_servers=16, pue=1.1,
    lan_idle_w=4000.0, lan_eps_w_per_gbps=0.01, lan_cap_gbps=51_200.0,
    lan_idle_share=0.03)

DCN_SWITCH = NetworkHW(name="dcn-switch", max_w=1200.0, idle_w=800.0,
                       cap_gbps=12_800.0, pue=1.1, idle_share=0.03)
WAN_ROUTER = NetworkHW(name="wan-router", max_w=3000.0, idle_w=2400.0,
                       cap_gbps=25_600.0, pue=1.5, idle_share=0.03)


def scaled(hw: ProcessingHW, **kw) -> ProcessingHW:
    """Return a copy of ``hw`` with fields overridden."""
    return dataclasses.replace(hw, **kw)
