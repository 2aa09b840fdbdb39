"""The port's in-process mesh (``repro_torch.launch.mesh``).

Coordinates follow ``jax.make_mesh``'s row-major layout; the collectives
have JAX's semantics (held against ``jax.lax`` on 8 host devices in
``tests/test_torch_executor.py`` through the executor, and here against
numpy); every rank receives its own copy; a rank that calls a collective
the others never reach raises within its timeout instead of hanging, and
``Mesh.run`` re-raises the first rank's error.
"""
import time

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import (
    CollectiveError,
    Mesh,
    make_mesh,
    make_production_mesh,
)


def _run(mesh, fn):
    return mesh.run(fn, [(r,) for r in range(mesh.size)])


def test_coordinates_are_row_major_with_model_fastest():
    mesh = make_mesh(2, 4, device="cpu")
    assert mesh.shape == {"data": 2, "model": 4} and mesh.size == 8
    assert [tuple(mesh.coords(r).values()) for r in range(8)] == [
        (d, m) for d in range(2) for m in range(4)]
    assert mesh.rank_of(data=1, model=2) == 6
    pods = make_mesh(2, 2, pods=2, device="cpu")
    assert pods.axis_names == ("pod", "data", "model")
    assert pods.coords(5) == {"pod": 1, "data": 0, "model": 1}
    assert make_production_mesh(device="cpu").shape == {"data": 16,
                                                        "model": 16}
    assert make_production_mesh(multi_pod=True, device="cpu").size == 512


def test_axis_index_and_group_index_inside_run():
    mesh = make_mesh(2, 4, device="cpu")
    out = _run(mesh, lambda r: (mesh.axis_index("data"),
                                mesh.axis_index("model"),
                                mesh.group_index(("data", "model")),
                                mesh.group_index(("model", "data"))))
    for r, (d, m, dm, md) in enumerate(out):
        assert (d, m, dm) == (r // 4, r % 4, r)
        assert md == m * 2 + d
    with pytest.raises(RuntimeError, match="outside Mesh.run"):
        mesh.axis_index("model")


@pytest.mark.parametrize("axes", ["model", "data", ("data", "model")])
def test_psum_sums_the_axis_group_in_rank_order(axes):
    mesh = make_mesh(2, 4, device="cpu")
    vals = [torch.tensor([float(2 ** r), 1.0 / (r + 1)]) for r in range(8)]
    out = _run(mesh, lambda r: mesh.psum(vals[r], axes))
    members = {"model": lambda r: [r // 4 * 4 + i for i in range(4)],
               "data": lambda r: [r % 4, r % 4 + 4]}
    for r, got in enumerate(out):
        group = (list(range(8)) if isinstance(axes, tuple)
                 else members[axes](r))
        want = vals[group[0]].clone()
        for g in group[1:]:
            want += vals[g]
        assert torch.equal(got, want)
        assert got.data_ptr() != vals[r].data_ptr()
    assert len({o.data_ptr() for o in out}) == 8  # each rank its own copy


@pytest.mark.parametrize("axes", ["model", "data", ("data", "model")])
def test_pmax_is_the_groups_elementwise_max_on_every_rank(axes):
    mesh = make_mesh(2, 4, device="cpu")
    rng = np.random.default_rng(2)
    vals = [torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
            for _ in range(8)]
    vals[3][0, 0] = -1e30  # NEG_INF of a fully masked shard
    out = _run(mesh, lambda r: (mesh.pmax(vals[r], axes),
                                mesh.axis_group(axes)))
    for r, (got, grp) in enumerate(out):
        members = [m for m in range(8) if all(
            mesh.coords(m)[a] == mesh.coords(r)[a] for a in ("data", "model")
            if a not in ((axes,) if isinstance(axes, str) else axes))]
        want = np.max(np.stack([vals[m].numpy() for m in members]), axis=0)
        assert np.array_equal(got.numpy(), want)
        assert got.data_ptr() != vals[r].data_ptr()
        assert (grp.index, grp.size) == (members.index(r), len(members))
    assert len({o[0].data_ptr() for o in out}) == 8
    assert mesh.counts["pmax"] == 8


def test_axis_group_collectives_are_the_meshs():
    mesh = make_mesh(2, 2, device="cpu")
    out = _run(mesh, lambda r: (
        mesh.axis_group("data").psum(torch.tensor([float(r)])),
        mesh.axis_group("data").pmax(torch.tensor([float(r)]))))
    for r, (s, m) in enumerate(out):
        assert float(s) == (r % 2) * 2 + 2 and float(m) == r % 2 + 2
    assert mesh.counts == {"psum": 4, "pmax": 4}


def test_a_pmax_nobody_else_reaches_times_out_and_aborts_the_others():
    mesh = Mesh({"data": 2, "model": 2}, timeout=0.5)

    def fn(r):
        if r == 0:
            return mesh.pmax(torch.ones(1), "data")  # rank 2 never comes
        if r == 2:
            time.sleep(1.5)
        return None

    t0 = time.monotonic()
    with pytest.raises(CollectiveError, match=r"rank 0.*pmax over data"
                       r".*timed out after 0.5 s.*\[2\]"):
        _run(mesh, fn)
    assert time.monotonic() - t0 < 10
    mesh = make_mesh(1, 3, device="cpu", timeout=30.0)

    def boom(r):
        if r == 1:
            raise KeyError("rank one's own fault")
        return mesh.pmax(torch.ones(1), "model")

    t0 = time.monotonic()
    with pytest.raises(KeyError, match="rank one's own fault"):
        _run(mesh, boom)
    assert time.monotonic() - t0 < 10  # the others' pmax aborted


def test_psum_scatter_and_all_gather_are_inverse_layouts():
    mesh = make_mesh(2, 4, device="cpu")
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.standard_normal((2, 5)).astype(np.float32))
          for _ in range(8)]

    def fn(r):
        part = mesh.psum_scatter(xs[r], "data")
        return part, mesh.all_gather(part, "data")

    out = _run(mesh, fn)
    for r, (part, full) in enumerate(out):
        a, b = xs[r % 4], xs[r % 4 + 4]
        np.testing.assert_array_equal(part.numpy(),
                                      (a + b)[r // 4].numpy())
        np.testing.assert_array_equal(full.numpy(),
                                      (a + b).reshape(-1).numpy())
    with pytest.raises(ValueError, match="group size"):
        _run(mesh, lambda r: mesh.psum_scatter(torch.zeros(3, 2), "data"))


def test_ppermute_moves_one_hop_and_zero_fills():
    mesh = make_mesh(1, 4, device="cpu")
    perm = [(i, i + 1) for i in range(3)]
    xs = [torch.full((2,), float(r)) for r in range(4)]
    out = _run(mesh, lambda r: mesh.ppermute((xs[r], r + 10, True),
                                             "model", perm))
    assert out[0][1:] == (0, False) and not out[0][0].any()
    for r in range(1, 4):
        t, mb, valid = out[r]
        assert torch.equal(t, xs[r - 1]) and (mb, valid) == (r + 9, True)
        assert t.data_ptr() != xs[r - 1].data_ptr()


def test_runs_are_bitwise_reproducible():
    mesh = make_mesh(2, 4, device="cpu")
    rng = np.random.default_rng(1)
    xs = [torch.from_numpy(rng.standard_normal(1000).astype(np.float32)
                           * 10 ** r) for r in range(8)]
    first = _run(mesh, lambda r: mesh.psum(xs[r], ("data", "model")))
    for _ in range(3):
        again = _run(mesh, lambda r: mesh.psum(xs[r], ("data", "model")))
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_a_rank_that_skips_a_collective_raises_not_hangs():
    mesh = Mesh({"data": 1, "model": 4}, timeout=60.0)

    def fn(r):
        if r == 2:
            return None  # never reaches the psum
        return mesh.psum(torch.ones(1), "model")

    t0 = time.monotonic()
    with pytest.raises(CollectiveError, match=r"psum over model.*\[2\]"):
        _run(mesh, fn)
    assert time.monotonic() - t0 < 30  # not the 60 s timeout


def test_a_collective_nobody_else_reaches_times_out_naming_it():
    mesh = Mesh({"data": 2, "model": 2}, timeout=0.5)

    def fn(r):
        if r == 0:
            return mesh.psum(torch.ones(1), "data")  # rank 2 never comes
        if r == 2:
            time.sleep(1.5)  # busy past the timeout, then returns
        return None

    t0 = time.monotonic()
    with pytest.raises(CollectiveError) as err:
        _run(mesh, fn)
    msg = str(err.value)
    assert "rank 0" in msg and "psum over data" in msg
    assert "timed out after 0.5 s" in msg and "[2]" in msg
    assert time.monotonic() - t0 < 10


def test_mismatched_collectives_and_rank_errors_surface_in_the_caller():
    mesh = make_mesh(1, 2, device="cpu", timeout=30.0)

    def mismatch(r):
        x = torch.ones(2)
        return (mesh.psum(x, "model") if r == 0 else
                mesh.all_gather(x, "model"))

    with pytest.raises(CollectiveError, match="different collectives"):
        _run(mesh, mismatch)

    def boom(r):
        if r == 1:
            raise KeyError("rank one's own fault")
        return mesh.psum(torch.ones(1), "model")

    t0 = time.monotonic()
    with pytest.raises(KeyError, match="rank one's own fault") as err:
        _run(mesh, boom)
    assert any("rank 1" in n for n in err.value.__notes__)
    assert time.monotonic() - t0 < 10
    # the mesh is reusable after a failed run
    assert [float(x) for x in _run(mesh, lambda r: mesh.psum(
        torch.ones(()), "model"))] == [2.0, 2.0]


def test_all_to_all_and_stacked_all_gather_match_their_definitions():
    """On a 2 x 4 mesh over ``model`` (groups of 4) and ``data`` (groups of
    2): row ``i`` of ``all_to_all`` is member ``i``'s row at this rank's
    group index; ``all_gather(tiled=False)`` stacks the members' tensors
    in group-index order."""
    mesh = make_mesh(2, 4, device="cpu")
    rng = np.random.default_rng(2)
    xs = {axis: [torch.from_numpy(rng.standard_normal(
        (mesh.shape[axis], 3, 2)).astype(np.float32)) for _ in range(8)]
        for axis in ("data", "model")}

    def fn(r):
        return {a: (mesh.all_to_all(xs[a][r], a),
                    mesh.all_gather(xs[a][r][0], a, tiled=False))
                for a in ("data", "model")}

    out = _run(mesh, fn)
    for r, got in enumerate(out):
        c = mesh.coords(r)
        for axis, (swapped, stacked) in got.items():
            members = [mesh.rank_of(**{**c, axis: i})
                       for i in range(mesh.shape[axis])]
            want = torch.stack([xs[axis][m][c[axis]] for m in members])
            assert torch.equal(swapped, want), (r, axis)
            assert torch.equal(stacked, torch.stack(
                [xs[axis][m][0] for m in members])), (r, axis)
            assert swapped.data_ptr() != xs[axis][r].data_ptr()
    with pytest.raises(ValueError, match="group size"):
        _run(mesh, lambda r: mesh.all_to_all(torch.zeros(3, 2), "data"))


@pytest.mark.parametrize("name", ["all_to_all", "all_gather",
                                  "psum_scatter"])
def test_each_exchange_and_its_transpose_are_adjoint(name):
    """``<A x, y> == <x, A^T y>`` summed over the ranks, in float64, for
    each exchange of a stage cut at its collectives and the transpose
    ``models/phases.py`` calls for it (``data`` groups of 2 on 2 x 4)."""
    from repro_torch.models.phases import TRANSPOSE

    mesh = make_mesh(2, 4, device="cpu")
    ex = mesh.exchange_over("data")
    rng = np.random.default_rng(3)
    shape = (2, 3, 5)
    xs = [torch.from_numpy(rng.standard_normal(shape)) for _ in range(8)]
    out_shape = {"all_to_all": shape, "all_gather": (2,) + shape,
                 "psum_scatter": shape[1:]}[name]
    ys = [torch.from_numpy(rng.standard_normal(out_shape))
          for _ in range(8)]
    got = _run(mesh, lambda r: (ex(name, xs[r]), ex(TRANSPOSE[name],
                                                    ys[r])))
    lhs = sum(float(torch.sum(a * y)) for (a, _), y in zip(got, ys))
    rhs = sum(float(torch.sum(x * b)) for x, (_, b) in zip(xs, got))
    assert got[0][0].shape == out_shape and got[0][1].shape == shape
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0), (lhs, rhs)


def _collective_in_backward(mesh, how: str):
    """A rank program whose backward calls ``mesh.psum``: inside a
    non-reentrant checkpoint's recompute, or in a Function.backward."""
    from torch.utils.checkpoint import checkpoint

    class Summed(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 2

        @staticmethod
        def backward(ctx, g):
            return mesh.psum(g, "data")

    def inner(x):
        if torch._C._current_graph_task_id() != -1:  # the recompute
            mesh.psum(x.detach(), "data")
        return torch.sin(x)

    def fn(r):
        x = torch.ones(3, requires_grad=True)
        y = (checkpoint(inner, x, use_reentrant=False) if how == "checkpoint"
             else Summed.apply(x))
        return torch.autograd.grad(y.sum(), x)

    return fn


@pytest.mark.parametrize("how", ["checkpoint", "function"])
def test_a_collective_inside_a_backward_raises_not_hangs(how):
    mesh = Mesh({"data": 2, "model": 1}, timeout=60.0)
    t0 = time.monotonic()
    with pytest.raises(CollectiveError, match="inside an autograd backward"):
        _run(mesh, _collective_in_backward(mesh, how))
    assert time.monotonic() - t0 < 30  # not the 60 s timeout
    # outside a backward the same collective goes through
    assert [float(x) for x in _run(mesh, lambda r: mesh.psum(
        torch.ones(()), "data"))] == [2.0, 2.0]
