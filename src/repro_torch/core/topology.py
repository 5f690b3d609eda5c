"""CFN physical topology: nodes, links, and the path-incidence tensor.

The paper's Fig. 1 architecture is a tree:

    IoT devices --(Wi-Fi)--> ONU APs --> OLT --> metro router --> metro switch
                                   \\-> AF                    \\-> MF
    metro switch --> core (IP/WDM ingress) --> core (IP/WDM egress) --> CDC

Because the substrate is a tree, the route between any two processing nodes is
unique, so flow conservation (paper Eq. 5) holds by construction once we record
for every ordered processing-node pair (b, e) which *network* nodes its route
traverses.  Real routes are SPARSE -- a metro/core route crosses <= ~15 network
nodes however large the substrate -- so the canonical representation is a
padded-CSR route table:

    route_idx[b, e, k]  -- the k-th network node on the (b, e) route
                           (int32; entries beyond the route's length hold the
                           sentinel value N, which every consumer masks out)
    route_len[b, e]     -- number of network nodes on the route (== path_hops)

Traffic aggregated by network node n is then a gather/segment-sum over the
route table (see power.py), O(P^2 * K) instead of the O(P^2 * N) dense
incidence contraction -- the representation that keeps city-scale substrates
(P in the hundreds, see ``city_scale``) on the accelerator hot path.  The
dense ``path_nodes`` tensor survives only as a test-side reference
constructor (``dense_path_nodes``).  A generic BFS router is used so meshed
cores (e.g. NSFNET, the paper's future work) drop in unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import hardware as hw

PROCESSING = "processing"
NETWORK = "network"

# Canonical layer tags used by solvers / benchmarks.
LAYER_IOT = "iot"
LAYER_AF = "af"
LAYER_MF = "mf"
LAYER_CDC = "cdc"


@dataclass
class CFNTopology:
    """A CFN substrate graph with hardware annotations.

    Processing nodes and network nodes have separate index spaces:
      * ``proc_names[p]`` / ``proc_hw[p]`` for p in [0, P)
      * ``net_names[n]`` / ``net_hw[n]`` for n in [0, N)
    ``adj`` is over the merged space (processing first, then network) and only
    used to derive ``path_nodes``.
    """

    proc_names: List[str] = field(default_factory=list)
    proc_hw: List[hw.ProcessingHW] = field(default_factory=list)
    proc_layer: List[str] = field(default_factory=list)   # iot/af/mf/cdc tag
    net_names: List[str] = field(default_factory=list)
    net_hw: List[hw.NetworkHW] = field(default_factory=list)
    edges: List[Tuple[str, str]] = field(default_factory=list)
    # derived (padded-CSR route table; see module docstring)
    route_idx: np.ndarray | None = None    # [P, P, K] int32, pad = N
    route_len: np.ndarray | None = None    # [P, P] int32 (#network nodes)
    path_hops: np.ndarray | None = None    # alias of route_len (legacy name)
    _dense_cache: np.ndarray | None = None

    # -- construction ------------------------------------------------------
    def add_proc(self, name: str, h: hw.ProcessingHW, layer: str) -> str:
        self.proc_names.append(name)
        self.proc_hw.append(h)
        self.proc_layer.append(layer)
        return name

    def add_net(self, name: str, h: hw.NetworkHW) -> str:
        self.net_names.append(name)
        self.net_hw.append(h)
        return name

    def connect(self, a: str, b: str) -> None:
        self.edges.append((a, b))

    # -- index helpers -----------------------------------------------------
    @property
    def P(self) -> int:
        return len(self.proc_names)

    @property
    def N(self) -> int:
        return len(self.net_names)

    def proc_index(self, name: str) -> int:
        return self.proc_names.index(name)

    def layer_indices(self, layer: str) -> List[int]:
        return [i for i, l in enumerate(self.proc_layer) if l == layer]

    @property
    def K(self) -> int:
        """Route padding width (max network nodes on any route)."""
        return 0 if self.route_idx is None else self.route_idx.shape[2]

    # -- routing -----------------------------------------------------------
    def finalize(self) -> "CFNTopology":
        """Compute the padded-CSR route table by BFS over the merged graph.

        One level-synchronous BFS from every processing node at once, in
        numpy.  A node's parent is the first frontier node, in discovery
        order, that lists it, taking each node's neighbours in edge order:
        the parent a queue-driven BFS from that source finds, so meshed
        cores keep their direction-dependent tie-breaks.  A route lists the
        network nodes walked from its end back to its start."""
        names = list(self.proc_names) + list(self.net_names)
        index: Dict[str, int] = {n: i for i, n in enumerate(names)}
        n_all = len(names)
        nbrs: List[List[int]] = [[] for _ in range(n_all)]
        for a, b in self.edges:
            ia, ib = index[a], index[b]
            nbrs[ia].append(ib)
            nbrs[ib].append(ia)
        deg = np.array([len(x) for x in nbrs], dtype=np.int64)
        first_nbr = np.cumsum(deg) - deg
        nbr = np.array([v for x in nbrs for v in x], dtype=np.int64)

        P, N = self.P, self.N
        src = np.arange(P, dtype=np.int64)
        prev = np.full((P, n_all), -1, dtype=np.int64)
        seen = np.zeros((P, n_all), dtype=bool)
        seen[src, src] = True
        # the frontier as (source, node) pairs, sorted by source and then
        # by discovery order; each level's (source, parent, node) triples
        fb, fu = src, src
        levels = []
        while fb.size:
            n_out = deg[fu]
            rows = np.repeat(np.arange(fb.size), n_out)
            k = np.arange(rows.size) - np.repeat(np.cumsum(n_out) - n_out,
                                                 n_out)
            eb, eu = fb[rows], fu[rows]
            ev = nbr[first_nbr[eu] + k]
            new = ~seen[eb, ev]
            eb, eu, ev = eb[new], eu[new], ev[new]
            # the first to reach a node wins; the order of first arrivals
            # is the next frontier's discovery order
            _, first = np.unique(eb * n_all + ev, return_index=True)
            first.sort()
            eb, eu, ev = eb[first], eu[first], ev[first]
            seen[eb, ev] = True
            prev[eb, ev] = eu
            levels.append((eb, eu, ev))
            fb, fu = eb, ev

        # chain[b, v]: the network nodes from v (itself included) back to b
        depth = max(len(levels), 1)
        chain = np.full((P, n_all, depth), N, dtype=np.int32)
        chain_len = np.zeros((P, n_all), dtype=np.int32)
        for eb, eu, ev in levels:
            net = ev >= P
            c = chain[eb, eu]
            c[net, 1:] = c[net, :-1]
            c[net, 0] = ev[net] - P
            chain[eb, ev] = c
            chain_len[eb, ev] = chain_len[eb, eu] + net
        # the (b, e) route is the chain of e's parent (b's own is empty;
        # so are the routes from b to itself and to nodes it cannot reach)
        b_i = np.broadcast_to(src[:, None], (P, P))
        par = np.where(prev[:, :P] >= 0, prev[:, :P], b_i)
        par[src, src] = src
        route_len = chain_len[b_i, par]
        K = max(1, int(route_len.max()))
        self.route_idx = np.ascontiguousarray(chain[b_i, par][:, :, :K])
        self.route_len = route_len
        self.path_hops = route_len
        self._dense_cache = None
        return self

    # -- dense reference (tests / oracles only) -----------------------------
    def dense_path_nodes(self) -> np.ndarray:
        """Materialize the dense ``[P, P, N]`` path-incidence tensor from the
        CSR route table.  O(P^2 * N) memory -- NOT used by any production
        code path; tests and benchmarks use it as the dense reference the
        sparse engine is checked against."""
        if self.route_idx is None:
            raise RuntimeError("finalize() the topology first")
        P, N, K = self.P, self.N, self.K
        dense = np.zeros((P, P, N + 1), dtype=np.float32)
        b, e, _ = np.indices(self.route_idx.shape)
        dense[b.reshape(-1), e.reshape(-1), self.route_idx.reshape(-1)] = 1.0
        return dense[:, :, :N]

    @property
    def path_nodes(self) -> np.ndarray:
        """Dense incidence tensor (cached); reference/test use only."""
        if self._dense_cache is None:
            self._dense_cache = self.dense_path_nodes()
        return self._dense_cache

    # -- parameter vectors (consumed by power.py) ---------------------------
    def proc_param_arrays(self) -> Dict[str, np.ndarray]:
        f = np.float32
        g = lambda attr: np.array([getattr(h, attr) for h in self.proc_hw], f)
        return dict(
            E=np.array([h.eps_w_per_gflops for h in self.proc_hw], f),
            C_pr=g("cap_gflops"),
            NS=g("n_servers"),
            pi_pr=g("idle_w"),
            pue_pr=g("pue"),
            EL=g("lan_eps_w_per_gbps"),
            C_lan=g("lan_cap_gbps"),
            pi_lan=g("lan_idle_w"),
            lan_share=g("lan_idle_share"),
        )

    def net_param_arrays(self) -> Dict[str, np.ndarray]:
        f = np.float32
        g = lambda attr: np.array([getattr(h, attr) for h in self.net_hw], f)
        return dict(
            eps=np.array([h.eps_w_per_gbps for h in self.net_hw], f),
            C_net=g("cap_gbps"),
            pi_net=g("idle_w"),
            pue_net=g("pue"),
            idle_share=g("idle_share"),
        )


def paper_topology(n_iot: int = 20, n_zones: int = 4,
                   af_servers: int | None = None,
                   mf_servers: int | None = None,
                   cdc_servers: int | None = None) -> CFNTopology:
    """The paper's evaluation substrate (§3): 20 IoT devices in 4 zones."""
    t = CFNTopology()
    af_hw = hw.AF_I5 if af_servers is None else hw.scaled(hw.AF_I5, n_servers=af_servers)
    mf_hw = hw.MF_I5 if mf_servers is None else hw.scaled(hw.MF_I5, n_servers=mf_servers)
    cdc_hw = hw.CDC_XEON if cdc_servers is None else hw.scaled(hw.CDC_XEON, n_servers=cdc_servers)

    for i in range(n_iot):
        t.add_proc(f"iot{i}", hw.IOT_RPI4, LAYER_IOT)
    t.add_proc("af0", af_hw, LAYER_AF)
    t.add_proc("mf0", mf_hw, LAYER_MF)
    t.add_proc("cdc0", cdc_hw, LAYER_CDC)

    for z in range(n_zones):
        t.add_net(f"onu{z}", hw.ONU_AP)
    t.add_net("olt0", hw.OLT)
    t.add_net("mrouter0", hw.METRO_ROUTER)
    t.add_net("mswitch0", hw.METRO_SWITCH)
    t.add_net("core0", hw.IPWDM_NODE)   # ingress (aggregation) core node
    t.add_net("core1", hw.IPWDM_NODE)   # egress core node, 1 hop / ~200 km
    # dedicated low-end attachment gear for the fog nodes (paper §2.1)
    t.add_net("af_router0", hw.LOW_END_ROUTER)
    t.add_net("af_switch0", hw.LOW_END_SWITCH)
    t.add_net("mf_router0", hw.LOW_END_ROUTER)
    t.add_net("mf_switch0", hw.LOW_END_SWITCH)

    for i in range(n_iot):
        t.connect(f"iot{i}", f"onu{i % n_zones}")
    for z in range(n_zones):
        t.connect(f"onu{z}", "olt0")
    t.connect("olt0", "af_router0")
    t.connect("af_router0", "af_switch0")
    t.connect("af_switch0", "af0")
    t.connect("olt0", "mrouter0")
    t.connect("mrouter0", "mswitch0")
    t.connect("mswitch0", "mf_router0")
    t.connect("mf_router0", "mf_switch0")
    t.connect("mf_switch0", "mf0")
    t.connect("mswitch0", "core0")
    t.connect("core0", "core1")
    t.connect("cdc0", "core1")
    return t.finalize()


# NSFNET 14-node core (paper §4 future work: "a realistic core network
# topology such as ... NSFNET").  Edges are the standard NSFNET T1 links.
NSFNET_EDGES = [
    (0, 1), (0, 2), (0, 7), (1, 2), (1, 3), (2, 5), (3, 4), (3, 10),
    (4, 5), (4, 6), (5, 9), (5, 13), (6, 7), (7, 8), (8, 9), (8, 11),
    (8, 12), (10, 11), (10, 12), (11, 13), (12, 13),
]


def nsfnet_topology(n_iot: int = 20, n_zones: int = 4,
                    access_core: int = 0, cdc_core: int = 8) -> CFNTopology:
    """The paper's CFN with the tree core replaced by the 14-node NSFNET.

    The access/metro side attaches at core node ``access_core``; the CDC
    hangs off ``cdc_core``.  Because the core is MESHED, routes are no
    longer unique -- the BFS router picks shortest paths, and the
    path-incidence contraction (and hence Eq. 1) still holds: this is the
    drop-in-core property claimed in the module docstring, exercised by
    tests/test_core_paper.py::test_nsfnet_flow_conservation.
    """
    t = CFNTopology()
    for i in range(n_iot):
        t.add_proc(f"iot{i}", hw.IOT_RPI4, LAYER_IOT)
    t.add_proc("af0", hw.AF_I5, LAYER_AF)
    t.add_proc("mf0", hw.MF_I5, LAYER_MF)
    t.add_proc("cdc0", hw.CDC_XEON, LAYER_CDC)

    for z in range(n_zones):
        t.add_net(f"onu{z}", hw.ONU_AP)
    t.add_net("olt0", hw.OLT)
    t.add_net("mrouter0", hw.METRO_ROUTER)
    t.add_net("mswitch0", hw.METRO_SWITCH)
    for c in range(14):
        t.add_net(f"core{c}", hw.IPWDM_NODE)
    t.add_net("af_router0", hw.LOW_END_ROUTER)
    t.add_net("af_switch0", hw.LOW_END_SWITCH)
    t.add_net("mf_router0", hw.LOW_END_ROUTER)
    t.add_net("mf_switch0", hw.LOW_END_SWITCH)

    for i in range(n_iot):
        t.connect(f"iot{i}", f"onu{i % n_zones}")
    for z in range(n_zones):
        t.connect(f"onu{z}", "olt0")
    t.connect("olt0", "af_router0")
    t.connect("af_router0", "af_switch0")
    t.connect("af_switch0", "af0")
    t.connect("olt0", "mrouter0")
    t.connect("mrouter0", "mswitch0")
    t.connect("mswitch0", "mf_router0")
    t.connect("mf_router0", "mf_switch0")
    t.connect("mf_switch0", "mf0")
    t.connect("mswitch0", f"core{access_core}")
    for a, b in NSFNET_EDGES:
        t.connect(f"core{a}", f"core{b}")
    t.connect("cdc0", f"core{cdc_core}")
    return t.finalize()


def city_scale(n_olt: int = 8, onus_per_olt: int = 6, iot_per_onu: int = 5,
               n_metro: int = 2, n_core: int = 6, n_cdc: int = 2,
               mf_servers: int = 8, cdc_servers: int = 64) -> CFNTopology:
    """City-wide PON fabric: the production-scale substrate preset.

    The paper's Fig. 1 tree replicated across a whole city, after the
    city-wide PON fabrics of arXiv:2005.00877 and the multi-tier fog
    hierarchies of arXiv:1808.06120:

      * ``n_olt`` access zones, each an OLT serving ``onus_per_olt`` ONU APs
        with ``iot_per_onu`` IoT devices each, plus one access-fog (AF) node
        behind dedicated low-end gear;
      * ``n_metro`` metro router/switch pairs, each aggregating an equal
        share of the OLT zones and hosting one metro-fog (MF) node;
      * an ``n_core``-node IP/WDM ring interconnecting the metro sites, with
        ``n_cdc`` cloud datacenters hanging off opposite sides of the ring.

    Defaults give P = 8*6*5 + 8 + 2 + 2 = 252 processing nodes and N ~ 88
    network nodes with routes of <= ~15 hops -- the regime where the CSR
    route table (P^2*K) is ~N/K smaller than the dense incidence tensor
    (P^2*N).  All knobs scale the fabric up or down (tests use a small
    instance; benchmarks sweep P).
    """
    t = CFNTopology()
    # processing nodes: IoT first (sources), then fog, then cloud
    for z in range(n_olt):
        for o in range(onus_per_olt):
            for i in range(iot_per_onu):
                t.add_proc(f"iot{z}_{o}_{i}", hw.IOT_RPI4, LAYER_IOT)
    for z in range(n_olt):
        t.add_proc(f"af{z}", hw.AF_I5, LAYER_AF)
    for m in range(n_metro):
        t.add_proc(f"mf{m}", hw.scaled(hw.MF_I5, n_servers=mf_servers),
                   LAYER_MF)
    for c in range(n_cdc):
        t.add_proc(f"cdc{c}", hw.scaled(hw.CDC_XEON, n_servers=cdc_servers),
                   LAYER_CDC)

    # network: access
    for z in range(n_olt):
        for o in range(onus_per_olt):
            t.add_net(f"onu{z}_{o}", hw.ONU_AP)
        t.add_net(f"olt{z}", hw.OLT)
        t.add_net(f"af_router{z}", hw.LOW_END_ROUTER)
        t.add_net(f"af_switch{z}", hw.LOW_END_SWITCH)
    # metro + core
    for m in range(n_metro):
        t.add_net(f"mrouter{m}", hw.METRO_ROUTER)
        t.add_net(f"mswitch{m}", hw.METRO_SWITCH)
        t.add_net(f"mf_router{m}", hw.LOW_END_ROUTER)
        t.add_net(f"mf_switch{m}", hw.LOW_END_SWITCH)
    for c in range(n_core):
        t.add_net(f"core{c}", hw.IPWDM_NODE)

    # wiring: access trees
    for z in range(n_olt):
        for o in range(onus_per_olt):
            for i in range(iot_per_onu):
                t.connect(f"iot{z}_{o}_{i}", f"onu{z}_{o}")
            t.connect(f"onu{z}_{o}", f"olt{z}")
        t.connect(f"olt{z}", f"af_router{z}")
        t.connect(f"af_router{z}", f"af_switch{z}")
        t.connect(f"af_switch{z}", f"af{z}")
        t.connect(f"olt{z}", f"mrouter{z % n_metro}")
    for m in range(n_metro):
        t.connect(f"mrouter{m}", f"mswitch{m}")
        t.connect(f"mswitch{m}", f"mf_router{m}")
        t.connect(f"mf_router{m}", f"mf_switch{m}")
        t.connect(f"mf_switch{m}", f"mf{m}")
        t.connect(f"mswitch{m}", f"core{(m * n_core) // max(1, n_metro)}")
    for c in range(n_core):
        t.connect(f"core{c}", f"core{(c + 1) % n_core}")
    for c in range(n_cdc):
        at = ((c * n_core) // max(1, n_cdc) + n_core // 4) % n_core
        t.connect(f"cdc{c}", f"core{at}")
    return t.finalize()


def federated_scale(n_regions: int = 4, n_olt: int = 2, onus_per_olt: int = 2,
                    iot_per_onu: int = 3, mf_servers: int = 4,
                    cdc_servers: int = 16, n_core: int = 14) -> CFNTopology:
    """Federated fog regions: ``n_regions`` city-style CFN regions stitched
    over a shared NSFNET-like IP/WDM core (the paper's §4 future work made
    a preset, after the cloud-fog federations of arXiv:2008.04004).

    Every region ``g`` is a self-contained Fig.-1-style fabric whose node
    names carry the ``r{g}_`` prefix (the convention
    ``core.federation.RegionPartition`` parses):

      * access: ``n_olt`` OLT zones of ``onus_per_olt`` ONU APs x
        ``iot_per_onu`` IoT devices, one AF node per zone behind dedicated
        low-end gear;
      * metro: one metro router/switch pair hosting the region's MF node;
      * region cloud: a CDC behind the region's own IP/WDM ingress/egress
        pair (``core_in0``/``core_out0``) -- so every intra-region route,
        including routes to the regional CDC, stays on region-prefixed
        network nodes.

    The shared core is ``n_core`` unprefixed ``nsf{c}`` IP/WDM nodes --
    the 14-node NSFNET mesh when ``n_core == 14``, a ring otherwise --
    and region ``g`` attaches its ``core_in0`` at core node
    ``(g * n_core) // n_regions``.  Only inter-region traffic ever touches
    the shared core, which is what lets ``core.federation`` decompose the
    substrate into per-region placement problems plus an inter-region
    core-link table.

    Defaults give 4 regions x 16 processing nodes (P = 64) over the NSFNET
    core; the knobs scale each region like ``city_scale``.
    """
    if n_regions < 1:
        raise ValueError(f"n_regions must be >= 1, got {n_regions}")
    t = CFNTopology()
    # processing nodes, region-major (merged proc index order groups regions)
    for g in range(n_regions):
        p = f"r{g}_"
        for z in range(n_olt):
            for o in range(onus_per_olt):
                for i in range(iot_per_onu):
                    t.add_proc(f"{p}iot{z}_{o}_{i}", hw.IOT_RPI4, LAYER_IOT)
        for z in range(n_olt):
            t.add_proc(f"{p}af{z}", hw.AF_I5, LAYER_AF)
        t.add_proc(f"{p}mf0", hw.scaled(hw.MF_I5, n_servers=mf_servers),
                   LAYER_MF)
        t.add_proc(f"{p}cdc0", hw.scaled(hw.CDC_XEON, n_servers=cdc_servers),
                   LAYER_CDC)
    # network nodes: regions first (region-major), shared core last
    for g in range(n_regions):
        p = f"r{g}_"
        for z in range(n_olt):
            for o in range(onus_per_olt):
                t.add_net(f"{p}onu{z}_{o}", hw.ONU_AP)
            t.add_net(f"{p}olt{z}", hw.OLT)
            t.add_net(f"{p}af_router{z}", hw.LOW_END_ROUTER)
            t.add_net(f"{p}af_switch{z}", hw.LOW_END_SWITCH)
        t.add_net(f"{p}mrouter0", hw.METRO_ROUTER)
        t.add_net(f"{p}mswitch0", hw.METRO_SWITCH)
        t.add_net(f"{p}mf_router0", hw.LOW_END_ROUTER)
        t.add_net(f"{p}mf_switch0", hw.LOW_END_SWITCH)
        t.add_net(f"{p}core_in0", hw.IPWDM_NODE)
        t.add_net(f"{p}core_out0", hw.IPWDM_NODE)
    for c in range(n_core):
        t.add_net(f"nsf{c}", hw.IPWDM_NODE)

    # wiring: each region is a tree hanging off one shared-core attachment
    for g in range(n_regions):
        p = f"r{g}_"
        for z in range(n_olt):
            for o in range(onus_per_olt):
                for i in range(iot_per_onu):
                    t.connect(f"{p}iot{z}_{o}_{i}", f"{p}onu{z}_{o}")
                t.connect(f"{p}onu{z}_{o}", f"{p}olt{z}")
            t.connect(f"{p}olt{z}", f"{p}af_router{z}")
            t.connect(f"{p}af_router{z}", f"{p}af_switch{z}")
            t.connect(f"{p}af_switch{z}", f"{p}af{z}")
            t.connect(f"{p}olt{z}", f"{p}mrouter0")
        t.connect(f"{p}mrouter0", f"{p}mswitch0")
        t.connect(f"{p}mswitch0", f"{p}mf_router0")
        t.connect(f"{p}mf_router0", f"{p}mf_switch0")
        t.connect(f"{p}mf_switch0", f"{p}mf0")
        t.connect(f"{p}mswitch0", f"{p}core_in0")
        t.connect(f"{p}core_in0", f"{p}core_out0")
        t.connect(f"{p}core_out0", f"{p}cdc0")
        t.connect(f"{p}core_in0", f"nsf{(g * n_core) // n_regions}")
    if n_core == 14:
        for a, b in NSFNET_EDGES:
            t.connect(f"nsf{a}", f"nsf{b}")
    else:
        for c in range(n_core):
            t.connect(f"nsf{c}", f"nsf{(c + 1) % n_core}")
    return t.finalize()


def datacenter_topology(n_edge: int = 8, n_fog: int = 2) -> CFNTopology:
    """Beyond-paper preset: TPU-pod-class nodes in the same CFN shape.

    Edge pods sit behind access DCN switches, fog pods behind a metro DCN
    switch, and the cloud pod behind a WAN router pair -- the datacenter
    analogue of Fig. 1 used to place the assigned LM architectures.
    """
    t = CFNTopology()
    for i in range(n_edge):
        t.add_proc(f"edge{i}", hw.EDGE_POD, LAYER_IOT)
    for i in range(n_fog):
        t.add_proc(f"fog{i}", hw.FOG_POD, LAYER_AF if i == 0 else LAYER_MF)
    t.add_proc("cloud0", hw.CLOUD_POD, LAYER_CDC)

    n_acc = max(1, n_edge // 4)
    for z in range(n_acc):
        t.add_net(f"acc{z}", hw.DCN_SWITCH)
    t.add_net("agg0", hw.DCN_SWITCH)
    t.add_net("wan0", hw.WAN_ROUTER)
    t.add_net("wan1", hw.WAN_ROUTER)

    for i in range(n_edge):
        t.connect(f"edge{i}", f"acc{i % n_acc}")
    for z in range(n_acc):
        t.connect(f"acc{z}", "agg0")
    for i in range(n_fog):
        t.connect(f"fog{i}", "agg0")
    t.connect("agg0", "wan0")
    t.connect("wan0", "wan1")
    t.connect("cloud0", "wan1")
    return t.finalize()
