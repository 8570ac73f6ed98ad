"""tpucg_torch's gather probes P1-P7 against ``benchmarks/probe_gather.py``
on the CPU: each probe's Pallas body, restated from the script with its
specs (``PrefetchScalarGridSpec`` for P5 and P6, the 512-row grid for P7),
runs in interpret mode on the script's inputs (``probe_inputs(0)``), and
the port's plain version must equal it bit for bit: the probes move data,
and P5 adds its windows in the body's order. A guard reads the script as
text, so a drift there fails here. The kernels themselves run only on the
card (``tests/test_torch_cuda.py``)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from _torch_helpers import rel_err  # noqa: F401  (sets torch threads)
from tpucg_torch.bench import probe_gather as drv
from tpucg_torch.bench.timing import gather_bytes
from tpucg_torch.kernels import probe_gather as kp

SCRIPT = Path(__file__).resolve().parents[1] / "benchmarks" / "probe_gather.py"
R, LANE, XR, NW, RB = 256, 128, 2048, 64, 8192
PIDS = [p.pid for p in drv.PROBES]
PROBE = {p.pid: p for p in drv.PROBES}


# ---- the script's probe bodies and specs, restated (probe_gather.py:66-191) -----


def lane_gather_kernel(v_ref, i_ref, o_ref):
    o_ref[...] = jnp.take_along_axis(v_ref[...], i_ref[...], axis=1)


def sub_gather_kernel(v_ref, i_ref, o_ref):
    o_ref[...] = jnp.take_along_axis(v_ref[...], i_ref[...], axis=0)


def row_gather_kernel(x_ref, i_ref, o_ref):
    o_ref[...] = jnp.take(x_ref[...], i_ref[...], axis=0)


def elem_gather_kernel(x_ref, i_ref, o_ref):
    o_ref[...] = jnp.take(x_ref[...], i_ref[...])


def dynslice_kernel(w_ref, x_ref, o_ref):
    def body(k, acc):
        row = x_ref[pl.ds(w_ref[k], 8), :]
        return acc + row
    acc = jax.lax.fori_loop(0, NW, body,
                            jnp.zeros((8, LANE), jnp.float32))
    o_ref[...] = acc


def roll_dyn_kernel(s_ref, x_ref, o_ref):
    o_ref[...] = pltpu.roll(x_ref[...], s_ref[0], 1)


def _tile(kernel):
    return pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((R, LANE), jnp.float32),
                          interpret=True)


def dynslice(w, x):
    return pl.pallas_call(
        dynslice_kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(1,),
            in_specs=[pl.BlockSpec((XR, LANE), lambda i, w: (0, 0))],
            out_specs=pl.BlockSpec((8, LANE), lambda i, w: (0, 0)),
        ),
        out_shape=jax.ShapeDtypeStruct((8, LANE), jnp.float32),
        interpret=True,
    )(w, x)


def roll_dyn(s, x):
    return pl.pallas_call(
        roll_dyn_kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(1,),
            in_specs=[pl.BlockSpec((R, LANE), lambda i, s: (0, 0))],
            out_specs=pl.BlockSpec((R, LANE), lambda i, s: (0, 0)),
        ),
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        interpret=True,
    )(s, x)


def lg_big(v, i):
    bs = 512
    return pl.pallas_call(
        lane_gather_kernel,
        grid=(RB // bs,),
        in_specs=[pl.BlockSpec((bs, LANE), lambda k: (k, 0)),
                  pl.BlockSpec((bs, LANE), lambda k: (k, 0))],
        out_specs=pl.BlockSpec((bs, LANE), lambda k: (k, 0)),
        out_shape=jax.ShapeDtypeStruct((RB, LANE), jnp.float32),
        interpret=True,
    )(v, i)


PALLAS = {
    "P1": _tile(lane_gather_kernel),
    "P2": _tile(sub_gather_kernel),
    "P3": _tile(row_gather_kernel),
    "P4": _tile(elem_gather_kernel),
    "P5": dynslice,
    "P6": roll_dyn,
    "P7": lg_big,
}


@pytest.fixture(scope="module")
def inputs():
    return drv.probe_inputs(0)


def _bits_equal(got, want) -> bool:
    got, want = np.asarray(got), np.asarray(want)
    return (got.dtype == want.dtype == np.float32 and got.shape == want.shape
            and np.array_equal(got.view(np.uint32), want.view(np.uint32)))


def _plain(pid, a, **override):
    p = PROBE[pid]
    t = drv.device_inputs({**a, **override}, "cpu")
    return p.plain(*p.args(t)).numpy()


@pytest.mark.parametrize("pid", PIDS)
def test_plain_equals_the_interpreted_pallas_body(inputs, pid):
    p = PROBE[pid]
    want = np.asarray(PALLAS[pid](*(jnp.asarray(x) for x in p.args(inputs))))
    assert _bits_equal(_plain(pid, inputs), want)


@pytest.mark.parametrize("shift", [5, 0, 1, 127])
def test_roll_equals_interpreted_pltpu_roll(inputs, shift):
    s = np.asarray([shift], np.int32)
    want = np.asarray(roll_dyn(jnp.asarray(s), jnp.asarray(inputs["V"])))
    assert _bits_equal(_plain("P6", inputs, shift=s), want)


@pytest.mark.parametrize("shift", [128, 300, -3])
def test_roll_equals_jnp_roll_past_the_row(inputs, shift):
    s = np.asarray([shift], np.int32)
    want = np.asarray(jnp.roll(jnp.asarray(inputs["V"]), shift, 1))
    assert _bits_equal(_plain("P6", inputs, shift=s), want)
    if shift % LANE:
        assert not _bits_equal(_plain("P6", inputs, shift=-s), want)  # direction matters


# The lines of benchmarks/probe_gather.py that this file and the port restate.
RESTATED = [
    'V = jnp.asarray(rng.standard_normal((R, LANE)), jnp.float32)',
    'LI = jnp.asarray(rng.integers(0, LANE, (R, LANE)), jnp.int32)',
    'sub_gather, V, jnp.asarray(rng.integers(0, R, (R, LANE)), jnp.int32),',
    'x2 = jnp.asarray(rng.standard_normal((XR, LANE)), jnp.float32)',
    'ridx = jnp.asarray(rng.integers(0, XR, (R,)), jnp.int32)',
    'xf = jnp.asarray(rng.standard_normal((XR * LANE,)), jnp.float32)',
    'eidx = jnp.asarray(rng.integers(0, XR * LANE, (R, LANE)), jnp.int32)',
    'widx = jnp.asarray(rng.integers(0, XR - 8, (NW,)), jnp.int32)',
    'roll_dyn, jnp.asarray([5], jnp.int32), V, elems=R * LANE)',
    'Vb = jnp.asarray(rng.standard_normal((RB, LANE)), jnp.float32)',
    'LIb = jnp.asarray(rng.integers(0, LANE, (RB, LANE)), jnp.int32)',
    '(jnp.asarray(rng.integers(0, XR, (2048,)), jnp.int32), x2),',
    '(jnp.asarray(rng.integers(0, XR * LANE, (2048, LANE)),',
]
BODIES = [
    'o_ref[...] = jnp.take_along_axis(v_ref[...], i_ref[...], axis=1)',
    'o_ref[...] = jnp.take_along_axis(v_ref[...], i_ref[...], axis=0)',
    'o_ref[...] = jnp.take(x_ref[...], i_ref[...], axis=0)',
    'o_ref[...] = jnp.take(x_ref[...], i_ref[...])',
    'row = x_ref[pl.ds(w_ref[k], 8), :]',
    'return acc + row',
    'acc = jax.lax.fori_loop(0, NW, body,',
    'jnp.zeros((8, LANE), jnp.float32))',
    'o_ref[...] = pltpu.roll(x_ref[...], s_ref[0], 1)',
    'num_scalar_prefetch=1,',
    'in_specs=[pl.BlockSpec((XR, LANE), lambda i, w: (0, 0))],',
    'in_specs=[pl.BlockSpec((R, LANE), lambda i, s: (0, 0))],',
    'bs = 512',
    'grid=(RB // bs,),',
    'in_specs=[pl.BlockSpec((bs, LANE), lambda k: (k, 0)),',
    'R = 256', 'XR = 2048', 'NW = 64', 'RB = 8192', 'LANE = 128',
]


def test_the_script_still_holds_what_is_restated():
    lines = [ln.strip() for ln in SCRIPT.read_text().splitlines()]
    calls = [i + 1 for i, ln in enumerate(lines) if "pl.pallas_call(" in ln]
    assert calls == [p.line for p in drv.PROBES]  # the kernel table cites these lines
    at = [lines.index(ln) for ln in RESTATED]     # the draws, in probe_inputs' order
    assert at == sorted(at)
    for ln in BODIES:  # a trailing comment may follow
        assert any(have.startswith(ln) for have in lines), ln


@pytest.mark.parametrize("key,shape,dtype,hi", [
    ("V", (R, LANE), np.float32, None), ("LI", (R, LANE), np.int32, LANE),
    ("SI", (R, LANE), np.int32, R), ("x2", (XR, LANE), np.float32, None),
    ("ridx", (R,), np.int32, XR), ("xf", (XR * LANE,), np.float32, None),
    ("eidx", (R, LANE), np.int32, XR * LANE), ("widx", (NW,), np.int32, XR - 8),
    ("Vb", (RB, LANE), np.float32, None), ("LIb", (RB, LANE), np.int32, LANE),
    ("base_ridx", (2048,), np.int32, XR), ("base_eidx", (2048, LANE), np.int32, XR * LANE),
    ("shift", (1,), np.int32, None),
])
def test_probe_inputs_shapes_and_ranges(inputs, key, shape, dtype, hi):
    a = inputs[key]
    assert a.shape == shape and a.dtype == dtype
    if hi is not None:
        assert a.min() >= 0 and a.max() < hi


def test_probe_inputs_are_the_scripts_first_draws(inputs):
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.standard_normal((R, LANE)), jnp.float32)
    li = jnp.asarray(rng.integers(0, LANE, (R, LANE)), jnp.int32)
    assert _bits_equal(inputs["V"], v) and np.array_equal(inputs["LI"], np.asarray(li))
    assert int(inputs["shift"][0]) == 5
    assert not np.array_equal(drv.probe_inputs(1)["V"], inputs["V"])


# Least bytes on probe_inputs(0): each distinct 32-byte sector read counts
# once. The closed form beside it charges every gathered unit its own sector
# (capped at the table) and bounds the count from above.
@pytest.mark.parametrize("pid,nbytes,closed_form", [
    ("P1", 393_216, 393_216), ("P2", 393_216, 393_216), ("P3", 257_536, 263_168),
    ("P4", 927_616, 1_310_720), ("P5", 242_432, 266_496), ("P6", 262_148, 262_148),
    ("P7", 12_581_792, 12_582_912),
])
def test_probe_bytes(inputs, pid, nbytes, closed_form):
    assert PROBE[pid].least_bytes(inputs) == nbytes <= closed_form


def test_p4_counts_the_sectors_its_indices_touch(inputs):
    sectors = np.unique(inputs["eidx"] // 8).size  # 8 f32 a sector
    assert PROBE["P4"].least_bytes(inputs) == 2 * 4 * R * LANE + 32 * sectors
    assert sectors < XR * LANE // 8  # a uniform draw misses about a third


def test_gather_bytes_caps_the_table_and_counts_sectors():
    assert gather_bytes(8, 8, np.asarray([0, 1, 7])) == 8 + 8 + 32    # one sector
    assert gather_bytes(8, 8, np.asarray([0, 8, 8])) == 8 + 8 + 64    # two
    assert gather_bytes(0, 0, np.arange(16), itemsize=2) == 32         # bf16: 16 a sector
    assert gather_bytes(0, 0, torch.arange(4 * LANE)) == 4 * 4 * LANE  # whole rows
    assert gather_bytes(0, 0, np.asarray([[9, 17], [9, 1]])) == 3 * 32  # any shape


@pytest.mark.parametrize("pid", PIDS)
def test_library_call_computes_the_probe(inputs, pid):
    p = PROBE[pid]
    t = drv.device_inputs(inputs, "cpu")
    label, call = p.library_call(t)
    assert label.startswith(("torch.", "torch.nn.functional."))
    got, want = call().numpy(), p.reference(*p.args(inputs))
    if pid == "P5":  # embedding_bag adds the windows in an order of its own
        assert label == "torch.nn.functional.embedding_bag(mode='sum')"
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        assert _bits_equal(got, want)


CPU_ARGS = {
    "lane_gather_cuda": lambda: (torch.zeros(4, LANE), torch.zeros(4, LANE, dtype=torch.int32)),
    "sub_gather_cuda": lambda: (torch.zeros(4, LANE), torch.zeros(2, LANE, dtype=torch.int32)),
    "row_gather_cuda": lambda: (torch.zeros(4, LANE), torch.zeros(3, dtype=torch.int32)),
    "elem_gather_cuda": lambda: (torch.zeros(64), torch.zeros(2, 5, dtype=torch.int32)),
    "dynslice_cuda": lambda: (torch.zeros(3, dtype=torch.int32), torch.zeros(16, LANE)),
    "roll_dyn_cuda": lambda: (torch.zeros(1, dtype=torch.int32), torch.zeros(4, LANE)),
}


@pytest.mark.parametrize("wrapper", sorted(CPU_ARGS))
def test_cuda_wrapper_refuses_cpu_tensors(wrapper):
    fn = getattr(kp, wrapper)
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA device"):
        fn(*CPU_ARGS[wrapper]())
    assert fn.launches == before


BAD_ARGS = {
    ("lane_gather_cuda", "dtype"): (torch.zeros(4, LANE), torch.zeros(4, LANE)),
    ("lane_gather_cuda", "shape"): (torch.zeros(4, LANE), torch.zeros(4, 64, dtype=torch.int32)),
    ("sub_gather_cuda", "dtype"): (torch.zeros(4, LANE, dtype=torch.float64),
                                   torch.zeros(2, LANE, dtype=torch.int32)),
    ("sub_gather_cuda", "shape"): (torch.zeros(4, 64), torch.zeros(2, 64, dtype=torch.int32)),
    ("row_gather_cuda", "dtype"): (torch.zeros(4, LANE), torch.zeros(3, dtype=torch.int64)),
    ("row_gather_cuda", "shape"): (torch.zeros(4, LANE), torch.zeros(3, 1, dtype=torch.int32)),
    ("elem_gather_cuda", "dtype"): (torch.zeros(64, dtype=torch.bfloat16),
                                    torch.zeros(5, dtype=torch.int32)),
    ("elem_gather_cuda", "shape"): (torch.zeros(8, 8), torch.zeros(5, dtype=torch.int32)),
    ("dynslice_cuda", "dtype"): (torch.zeros(3), torch.zeros(16, LANE)),
    ("dynslice_cuda", "shape"): (torch.zeros(0, dtype=torch.int32), torch.zeros(16, LANE)),
    ("roll_dyn_cuda", "dtype"): (torch.zeros(1, dtype=torch.int64), torch.zeros(4, LANE)),
    ("roll_dyn_cuda", "shape"): (torch.zeros(2, dtype=torch.int32), torch.zeros(4, LANE)),
}


@pytest.mark.parametrize("wrapper,what", sorted(BAD_ARGS))
def test_cuda_wrapper_refuses_wrong_dtype_or_shape(wrapper, what):
    with pytest.raises(ValueError, match=f"{wrapper}: .* must be a contiguous"):
        getattr(kp, wrapper)(*BAD_ARGS[(wrapper, what)])


def test_dynslice_cuda_refuses_more_windows_than_it_holds():
    w = torch.zeros(kp.MAX_WINDOWS + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 1024 windows"):
        kp.dynslice_cuda(w, torch.zeros(16, LANE))


def test_dispatchers_send_cpu_tensors_to_the_plain_versions(inputs):
    t = drv.device_inputs(inputs, "cpu")
    for p in drv.PROBES:
        plain, kernel = p.plain, getattr(kp, p.kernel)
        before = (plain.launches, kernel.launches)
        p.run(*p.args(t))
        assert (plain.launches, kernel.launches) == (before[0] + 1, before[1]), p.pid
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        kp.lane_gather(t["V"], t["LI"], backend="cuda")


@pytest.mark.parametrize("case", ["sub_gather_rows", "elem_gather_1d", "dynslice_one_window",
                                  "row_gather_repeats"])
def test_plain_versions_off_the_script_shapes(case):
    rng = np.random.default_rng(3)
    v = rng.standard_normal((40, LANE)).astype(np.float32)
    tv = torch.from_numpy(v)
    if case == "sub_gather_rows":
        idx = rng.integers(0, 40, (7, LANE)).astype(np.int32)
        got, want = kp.sub_gather(tv, torch.from_numpy(idx)), np.take_along_axis(v, idx, 0)
    elif case == "elem_gather_1d":
        idx = rng.integers(0, v.size, (33,)).astype(np.int32)
        got, want = kp.elem_gather(tv.reshape(-1), torch.from_numpy(idx)), v.reshape(-1)[idx]
    elif case == "dynslice_one_window":
        w = np.asarray([31], np.int32)
        got, want = kp.dynslice(torch.from_numpy(w), tv), v[31:39]
    else:
        idx = np.asarray([3, 3, 0, 39], np.int32)
        got, want = kp.row_gather(tv, torch.from_numpy(idx)), v[idx]
    assert _bits_equal(got.numpy(), want)


def test_driver_main_on_the_cpu(capsys):
    assert drv.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in out[:7]] == PIDS
    assert all("equals NumPy indexing bit for bit" in ln for ln in out[:7])
    assert "least bytes 927616, bound 0.277 us" in out[3]  # P4
    assert "no time is taken off the card" in out[-1]


def test_well_slot_columns_read_every_stored_column_once():
    # The WELL-order line of the FEM-scale timing reads x once per stored
    # nonzero (the identity tail included), as the CSR-order line does,
    # only in slot order.
    from tpucg_torch.io.generator import fem_p1_system

    A = fem_p1_system(1500, seed=0)[0]
    cols, npad = drv.well_slot_columns(A)
    n = A.shape[0]
    assert npad == -(-n // 128) * 128
    want = np.r_[A.indices[A.data != 0], np.arange(n, npad)]
    np.testing.assert_array_equal(np.sort(cols), np.sort(want))
    assert not np.array_equal(cols, np.sort(cols))  # slot order, not column order


def test_driver_on_the_card_needs_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        drv.main([])
