"""Substrate and workload of the PyTorch port against the JAX package:
route tables, parameter arrays and VSR batches must be byte-equal for the
same presets and seeds (both are numpy code; the port keeps its own copy)."""
import numpy as np
import pytest

from repro.core import topology as jtopo, vsr as jvsr
from repro_torch.core import topology as ttopo, vsr as tvsr

PRESETS = {
    "paper": dict(fn="paper_topology", kw={}),
    "paper_small": dict(fn="paper_topology", kw=dict(n_iot=4, n_zones=2)),
    "nsfnet": dict(fn="nsfnet_topology", kw={}),
    "city_small": dict(fn="city_scale",
                       kw=dict(n_olt=2, onus_per_olt=4, iot_per_onu=8)),
    "federated_small": dict(fn="federated_scale",
                            kw=dict(n_regions=2, n_olt=1, onus_per_olt=2)),
    "datacenter": dict(fn="datacenter_topology", kw={}),
}


def _both(name):
    spec = PRESETS[name]
    return (getattr(jtopo, spec["fn"])(**spec["kw"]),
            getattr(ttopo, spec["fn"])(**spec["kw"]))


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_route_tables_byte_equal(name):
    ref, port = _both(name)
    assert port.proc_names == ref.proc_names
    assert port.net_names == ref.net_names
    assert port.proc_layer == ref.proc_layer
    for field in ("route_idx", "route_len", "path_hops"):
        a, b = getattr(ref, field), getattr(port, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert a.tobytes() == b.tobytes(), field
    assert port.K == ref.K


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_parameter_arrays_byte_equal(name):
    ref, port = _both(name)
    for getter in ("proc_param_arrays", "net_param_arrays"):
        a, b = getattr(ref, getter)(), getattr(port, getter)()
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            assert a[k].tobytes() == b[k].tobytes(), k


def test_direction_dependent_tie_breaks_kept():
    """Meshed cores break equal-cost ties by BFS direction: the port keeps
    the reference's asymmetric routes instead of symmetrizing them."""
    ref, port = _both("nsfnet")
    np.testing.assert_array_equal(port.route_idx, ref.route_idx)
    np.testing.assert_array_equal(port.dense_path_nodes(),
                                  ref.dense_path_nodes())


def test_city_p468_shape():
    t = ttopo.city_scale(n_olt=16, onus_per_olt=4, iot_per_onu=7)
    assert (t.P, t.N, t.K) == (468, 126, 14)
    assert t.route_idx.dtype == np.int32
    assert t.route_idx.nbytes == 468 * 468 * 14 * 4


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("topology", ["chain", "star", "dag"])
def test_vsr_batches_byte_equal(seed, topology):
    kw = dict(n_vms=4, source_nodes=[0, 3, 5], topology=topology)
    a = jvsr.random_vsrs(9, rng=seed, **kw)
    b = tvsr.random_vsrs(9, rng=seed, **kw)
    for field in ("F", "H", "src", "input_vm"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), field
    for x, y in zip(a.links(), b.links()):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_vsr_concat_matches_reference():
    a = [jvsr.random_vsrs(3, rng=1, n_vms=2), jvsr.random_vsrs(2, rng=2,
                                                                n_vms=4)]
    b = [tvsr.random_vsrs(3, rng=1, n_vms=2), tvsr.random_vsrs(2, rng=2,
                                                                n_vms=4)]
    ref = a[0].concat(a[1])
    for port in (b[0].concat(b[1]), tvsr.concat_all(b)):
        for field in ("F", "H", "src", "input_vm"):
            x, y = getattr(ref, field), getattr(port, field)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), field


def test_unknown_virtual_topology_raises():
    with pytest.raises(ValueError):
        tvsr.random_vsrs(2, topology="ring")
