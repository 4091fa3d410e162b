"""Native C++ runtime components (native/nlps_native.cpp via ctypes):
GiD parser and linear-time mesh topology vs the Python implementations."""

import numpy as np
import pytest

from nlpartsol.io import native
from nlpartsol.io import gid_mesh

from tests.test_io import write_gid_quad_mesh


@pytest.fixture(scope="module")
def have_native():
    if not native.available():
        pytest.skip("native library unavailable (g++ missing?)")


def test_native_gid_parser_matches_python(tmp_path, have_native):
    write_gid_quad_mesh(tmp_path / "m.msh", 7, 5, 0.25)
    py = gid_mesh.read_gid_mesh(str(tmp_path / "m.msh"))
    out = native.read_gid_mesh_native(str(tmp_path / "m.msh"))
    assert out is not None
    dim, name, coords, conn = out
    assert dim == py.dimension
    np.testing.assert_allclose(coords, py.coords, rtol=1e-12)
    np.testing.assert_array_equal(conn, py.connectivity)


def test_native_topology(tmp_path, have_native):
    nx, ny, h = 6, 4, 0.5
    write_gid_quad_mesh(tmp_path / "m.msh", nx, ny, h)
    py = gid_mesh.read_gid_mesh(str(tmp_path / "m.msh"))
    top = native.mesh_topology(py.coords, py.connectivity, py.dimension)
    assert top is not None
    n_nodes = py.coords.shape[0]
    # node→element adjacency: every element listed under each of its nodes
    for e in range(py.connectivity.shape[0]):
        for n in py.connectivity[e]:
            elems = top.node_elem_idx[top.node_elem_off[n]:top.node_elem_off[n + 1]]
            assert e in elems
    # interior node of a quad grid touches 4 elements, 8 ring-1 neighbors
    interior = [
        i for i in range(n_nodes)
        if top.node_elem_off[i + 1] - top.node_elem_off[i] == 4
    ]
    assert len(interior) == (nx - 1) * (ny - 1)
    i = interior[0]
    assert top.node_node_off[i + 1] - top.node_node_off[i] == 8
    # boundary: the outer ring exactly
    xy = py.coords
    on_edge = (
        np.isclose(xy[:, 0], xy[:, 0].min()) | np.isclose(xy[:, 0], xy[:, 0].max())
        | np.isclose(xy[:, 1], xy[:, 1].min()) | np.isclose(xy[:, 1], xy[:, 1].max())
    )
    np.testing.assert_array_equal(top.boundary, on_edge)
    assert top.min_dx == pytest.approx(h)


def test_native_ring_expand(tmp_path, have_native):
    write_gid_quad_mesh(tmp_path / "m.msh", 8, 8, 1.0)
    py = gid_mesh.read_gid_mesh(str(tmp_path / "m.msh"))
    top = native.mesh_topology(py.coords, py.connectivity, py.dimension)
    off2, idx2 = native.ring_localities(top, rings=2)
    # a deep-interior node's 2-ring on a quad grid is the 5x5 block minus itself
    n_nodes = py.coords.shape[0]
    deep = None
    for i in range(n_nodes):
        if off2[i + 1] - off2[i] == 24:
            deep = i
            break
    assert deep is not None
    ring = idx2[off2[deep]:off2[deep + 1]]
    xy = py.coords
    d = np.abs(xy[ring] - xy[deep]).max(axis=1)
    assert (d <= 2.0 + 1e-9).all()
