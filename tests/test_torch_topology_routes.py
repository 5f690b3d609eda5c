"""The port's route builder (``CFNTopology.finalize``: one BFS from every
processing node at once, in numpy) against the JAX package's per-source
BFS on random graphs: meshes with equal-cost ties, duplicate edges,
processing nodes inside routes and nodes no route reaches.  Route tables
must be byte-equal."""
import numpy as np
import pytest

from repro.core import hardware as jhw, topology as jtopo
from repro_torch.core import hardware as thw, topology as ttopo


def _random_pair(seed):
    r = np.random.default_rng(seed)
    n_proc, n_net = int(r.integers(1, 14)), int(r.integers(0, 14))
    names = [f"p{i}" for i in range(n_proc)] + [f"n{i}" for i in
                                                range(n_net)]
    edges = [tuple(r.choice(len(names), 2, replace=False))
             for _ in range(int(r.integers(0, 3 * len(names))))
             if len(names) > 1]
    out = []
    for mod, hw in ((jtopo, jhw), (ttopo, thw)):
        t = mod.CFNTopology()
        for n in names[:n_proc]:
            t.add_proc(n, hw.IOT_RPI4, "iot")
        for n in names[n_proc:]:
            t.add_net(n, hw.ONU_AP)
        for a, b in edges:
            t.connect(names[a], names[b])
        out.append(t.finalize())
    return out


@pytest.mark.parametrize("block", range(4))
def test_random_graph_routes_byte_equal(block):
    for seed in range(50 * block, 50 * block + 50):
        ref, port = _random_pair(seed)
        for field in ("route_idx", "route_len", "path_hops"):
            a, b = getattr(ref, field), getattr(port, field)
            assert a.dtype == b.dtype and a.shape == b.shape, (seed, field)
            assert a.tobytes() == b.tobytes(), (seed, field)


def test_federated_city_regions_routes_byte_equal():
    """Two city-scale regions over the NSFNET core (P = 468): the
    four-region substrate's shape at half its regions and half its OLT
    zones."""
    kw = dict(n_regions=2, n_olt=8, onus_per_olt=4, iot_per_onu=7)
    ref, port = jtopo.federated_scale(**kw), ttopo.federated_scale(**kw)
    assert port.P == ref.P
    assert port.route_idx.tobytes() == ref.route_idx.tobytes()
    assert port.route_len.tobytes() == ref.route_len.tobytes()
