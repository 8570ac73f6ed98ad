"""The CLI's last parts (ROADMAP M15) against tpucg's ``main``, both run
in-process on the CPU on the same seeded inputs: ``generate`` and every arm
of ``convert`` give the same bytes; ``solve --deflate`` the same laps, x
within 1e-5 of max |x| and the same refusals, serially and on a gloo world
of 2 (tpucg's ``--strategy allgather --devices 2`` on the conftest's CPU
devices); ``--devices``; ``info --spectrum``, whose interval gives the same
Chebyshev laps; ``bench --json`` and ``--tol``; ``--debug-nans``; and
``selftest``'s mesh checks. The world of 2 is spawned once for the module
and runs its commands on files the parent writes."""

import dataclasses
import json
import os
import re

import jax
import numpy as np
import pytest

import tpucg.cli as jcli
from _torch_helpers import cli_world_worker, run_world, scaled_err
from tpucg.bench.timing import BenchReport as JBenchReport
from tpucg_torch import cli
from tpucg_torch.bench.timing import BenchReport, Timing
from tpucg_torch.io.generator import poisson3d_csr, random_geometric_spd
from tpucg_torch.io.mmio import save_matrix_market
from tpucg_torch.io.textio import load_vector, save_array

N = 128  # a multiple of 128: the port's padded operator is tpucg's unpadded one


def _clustered_spd(n, n_small=3, seed=0):
    """tpucg's deflation test system (``tests/test_deflation.py``): n_small
    eigenvalues at 0.01, 0.02, ... under a [1, 2] bulk, and their
    eigenvectors."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.concatenate([0.01 * (1.0 + np.arange(n_small)),
                          1.0 + rng.uniform(0.0, 1.0, n - n_small)])
    A = (Q * lam) @ Q.T
    return (0.5 * (A + A.T)).astype(np.float32), Q[:, :n_small].astype(np.float32)


def _laps(out):
    return int(re.search(r"iterations\s+: (\d+)", out).group(1))


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    """The deflation system's files: A and b in the reference's text format,
    V as .npy and .mtx, one column of it as a vector, and a V with a row
    too few."""
    d = tmp_path_factory.mktemp("m15")
    A, V = _clustered_spd(N, seed=40)
    b = np.random.default_rng(41).standard_normal(N).astype(np.float32)
    paths = {k: str(d / f) for k, f in (("A", "A.txt"), ("b", "b.txt"), ("V", "V.npy"),
                                          ("Vmtx", "V.mtx"), ("V1", "V1.npy"),
                                          ("Vbad", "Vbad.npy"), ("dir", "."))}
    save_array(paths["A"], A, fmt="%r")
    save_array(paths["b"], b, fmt="%r")
    np.save(paths["V"], V)
    save_matrix_market(paths["Vmtx"], V)
    np.save(paths["V1"], V[:, 0])
    np.save(paths["Vbad"], V[1:])
    paths["dir"] = str(d)
    return b, paths, 1e-5 * float(np.linalg.norm(b))


@pytest.fixture(scope="module")
def world2(system):
    """One gloo world of 2 ranks, spawned once, running the mesh commands
    of this module: the deflated solve under both strategies, --devices
    equal to, above and below the world's size, and selftest."""
    _, p, tol = system
    base = ["solve", p["A"], p["b"], "--deflate", p["V"], "--tol", repr(tol), "--device", "cpu"]
    argvs = {
        "allgather": base + ["--strategy", "allgather", "--devices", "2",
                             "--output", os.path.join(p["dir"], "x_w2_allgather.txt")],
        "overlap": base + ["--strategy", "overlap", "--output",
                           os.path.join(p["dir"], "x_w2_overlap.txt")],
        "devices_above": base + ["--strategy", "allgather", "--devices", "3"],
        "devices_below": base + ["--strategy", "allgather", "--devices", "1"],
        "selftest": ["selftest", "--device", "cpu", "--n", "64"],
    }
    got = run_world(2, cli_world_worker, args=(list(argvs.values()),),
                    rendezvous=os.path.join(p["dir"], "rv"), timeout_s=300)
    return dict(zip(argvs, got))


# ---- generate and convert: byte contracts -------------------------------------


@pytest.mark.parametrize("n,seed", [(32, 3), (50, 0)])
def test_generate_writes_tpucgs_bytes(tmp_path, n, seed, capsys):
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    assert cli.main(["generate", str(n), "--seed", str(seed), "--out-dir", str(ours)]) == 0
    assert jcli.main(["generate", str(n), "--seed", str(seed), "--out-dir", str(theirs)]) == 0
    names = [f"matrix{n}X{n}.txt", f"vector{n}X1.txt", f"X{n}X1.txt"]
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs)) == sorted(names)
    for name in names:
        assert (ours / name).read_bytes() == (theirs / name).read_bytes(), name
    out = capsys.readouterr().out
    assert out.count("wrote ") == 2


def _sources(d):
    """convert's inputs: a text matrix and vector, their .npy, and a
    symmetric sparse .mtx."""
    rng = np.random.default_rng(5)
    A = rng.standard_normal((12, 12)).astype(np.float32)
    v = rng.standard_normal(12).astype(np.float32)
    src = {"A.txt": A, "v.txt": v}
    for name, arr in src.items():
        save_array(str(d / name), arr, fmt="%r")
    np.save(d / "A.npy", A)
    np.save(d / "v.npy", v)
    csr, _, _ = random_geometric_spd(300, seed=4, avg_degree=6.0)
    save_matrix_market(str(d / "G_sym.mtx"), csr.to_coo(), symmetric=True)


CONVERT_ARMS = [
    ("G_sym.mtx", "G.mtx", []),  # expand + row-sort + sidecar
    ("G_sym.mtx", "G.npy", []),  # a COO densified
    ("G_sym.mtx", "G.txt", ["--fmt", "%.6e"]),
    ("A.txt", "A.mtx", []),
    ("v.txt", "v.mtx", ["--kind", "vector"]),
    ("A.npy", "A2.mtx", []),
    ("A.txt", "A2.npy", ["--n", "12"]),
    ("v.txt", "v2.npy", ["--kind", "vector"]),
    ("A.npy", "A2.txt", []),
    ("v.npy", "v2.txt", ["--fmt", "%.4f"]),
]


@pytest.mark.parametrize("src,dst,flags", CONVERT_ARMS, ids=[f"{s}->{d}" for s, d, _ in
                                                            CONVERT_ARMS])
def test_convert_writes_tpucgs_bytes(tmp_path, capsys, src, dst, flags):
    _sources(tmp_path)
    for main, side in ((cli.main, "ours"), (jcli.main, "theirs")):
        (tmp_path / side).mkdir()
        assert main(["convert", str(tmp_path / src), str(tmp_path / side / dst)] + flags) == 0
    out = capsys.readouterr().out
    ours, theirs = sorted(os.listdir(tmp_path / "ours")), sorted(os.listdir(tmp_path / "theirs"))
    assert ours == theirs and len(ours) == (2 if dst == "G.mtx" else 1), (ours, theirs)
    for name in ours:  # the .mtx -> .mtx arm: the file and its sidecar
        assert (tmp_path / "ours" / name).read_bytes() == \
            (tmp_path / "theirs" / name).read_bytes(), name
    assert out.count("wrote ") == 2


def test_convert_refuses_as_tpucg_does(tmp_path):
    _sources(tmp_path)
    texts = []
    for main in (cli.main, jcli.main):
        with pytest.raises(SystemExit) as e:
            main(["convert", str(tmp_path / "A.txt"), str(tmp_path / "B.txt")])
        texts.append(str(e.value))
    assert texts[0] == texts[1] == "one of src/dst must be a .npy or .mtx file"


# ---- solve --deflate ----------------------------------------------------------


@pytest.mark.parametrize("v", ["V", "Vmtx", "V1"])
def test_solve_deflate_serial_matches_tpucg(system, capsys, v):
    _, p, tol = system
    outs = {}
    for main, side in ((cli.main, "ours"), (jcli.main, "theirs")):
        x = os.path.join(p["dir"], f"x_{v}_{side}.txt")
        argv = ["solve", p["A"], p["b"], "--deflate", p[v], "--tol", repr(tol), "--output", x]
        rc = main(argv + (["--device", "cpu"] if side == "ours" else []))
        out = capsys.readouterr().out
        assert rc == 0, out
        outs[side] = (_laps(out), load_vector(x, n=N), out)
    m = 1 if v == "V1" else 3
    for side in outs:
        assert f"[deflated m={m}]" in outs[side][2] and "converged            : True" in outs[
            side][2]
    assert outs["ours"][0] == outs["theirs"][0]
    assert scaled_err(outs["ours"][1], outs["theirs"][1]) <= 1e-5


def test_solve_deflate_residual_history_as_tpucg(system, capsys):
    _, p, tol = system
    for main, extra in ((cli.main, ["--device", "cpu"]), (jcli.main, [])):
        rc = main(["solve", p["A"], p["b"], "--deflate", p["V"], "--tol", repr(tol),
                   "--residual-history"] + extra)
        out = capsys.readouterr().out
        assert rc == 0 and "||r_0||" in out, out
        rc = main(["solve", p["A"], p["b"], "--deflate", p["V"], "--tol", repr(tol),
                   "--residual-history", "--method", "cg", "--strategy", "allgather"] + extra)
        out = capsys.readouterr().out
        assert rc == 0 and "no history will be recorded" in out and "||r_0||" not in out, out


def test_solve_deflate_on_a_world_of_two_matches_tpucg(system, world2, capsys):
    _, p, tol = system
    for strategy in ("allgather", "overlap"):
        x = os.path.join(p["dir"], f"jx_{strategy}.txt")
        rc = jcli.main(["solve", p["A"], p["b"], "--deflate", p["V"], "--tol", repr(tol),
                        "--strategy", strategy, "--devices", "2", "--output", x])
        jout = capsys.readouterr().out
        rc_ours, out = world2[strategy]
        assert rc == rc_ours == 0, out + jout
        assert "rank 0 of 2" in out and "[deflated m=3]" in out
        assert _laps(out) == _laps(jout), (out, jout)
        ours = load_vector(os.path.join(p["dir"], f"x_w2_{strategy}.txt"), n=N)
        assert scaled_err(ours, load_vector(x, n=N)) <= 1e-5


def test_solve_deflate_refusals_are_tpucgs(system, tmp_path):
    _, p, tol = system
    csr = poisson3d_csr(2)
    pa, pb = str(tmp_path / "A.mtx"), str(tmp_path / "b.mtx")
    save_matrix_market(pa, csr.to_coo(), symmetric=True)
    save_matrix_market(pb, np.ones(csr.shape[0], np.float32))
    cases = [
        (["solve", pa, pb, "--deflate", pb], SystemExit),
        (["solve", p["A"], p["b"], "--deflate", p["V"], "--checkpoint",
          str(tmp_path / "ck.npz")], SystemExit),
        (["solve", p["A"], p["b"], "--deflate", p["Vbad"]], SystemExit),
        (["solve", p["A"], p["b"], "--deflate", p["b"]], SystemExit),
        (["solve", p["A"], p["b"], "--deflate", p["V"], "--method", "pipelined"], ValueError),
    ]
    for argv, exc in cases:
        texts = []
        for main, extra in ((cli.main, ["--device", "cpu"]), (jcli.main, [])):
            with pytest.raises(exc) as e:
                main(argv + extra)
            texts.append(str(e.value))
        if exc is SystemExit:
            assert texts[0] == texts[1], texts
        else:  # both name the method guard
            assert all("method" in t for t in texts), texts


# ---- --devices ----------------------------------------------------------------


def test_devices_above_the_world_is_tpucgs_error(system):
    _, p, _ = system
    argv = ["solve", p["A"], p["b"], "--strategy", "allgather"]
    with pytest.raises(ValueError, match=r"^requested 9 devices, only 8 present$"):
        jcli.main(argv + ["--devices", "9"])
    with pytest.raises(ValueError, match=r"^requested 2 devices, only 1 present$"):
        cli.main(argv + ["--devices", "2", "--device", "cpu"])


def test_devices_on_a_world_of_two(world2):
    rc, out = world2["allgather"]
    assert rc == 0 and "converged            : True" in out  # K == P runs
    rc, _ = world2["devices_above"]
    assert rc == "ValueError: requested 3 devices, only 2 present"
    # K < P: the port's mesh spans the whole world (an intended difference:
    # tpucg would take the first K devices).
    rc, _ = world2["devices_below"]
    assert rc.startswith("ValueError: requested 1 devices of a world of 2 ranks")


def test_serial_solve_ignores_devices(system, capsys):
    _, p, _ = system
    for main, extra in ((cli.main, ["--device", "cpu"]), (jcli.main, [])):
        assert main(["solve", p["A"], p["b"], "--devices", "64"] + extra) == 0
    capsys.readouterr()


# ---- info --spectrum and --interval --------------------------------------------

# The two packages' 16 power-iteration products sum in other orders: their
# bounds differ by f32 rounding of lam_hi. Held within SPECTRUM_RTOL of
# lam_hi (lam_lo = lam_hi - the reflected estimate, so its error is lam_hi's
# scale); measured at most 1.1e-6 relative for lam_hi and 5.3e-7 of lam_hi
# for lam_lo over these four matrices.
SPECTRUM_RTOL = 1e-5


def _spectrum_files(d):
    from tpucg_torch.io.generator import generate_spd_system

    A, b, _ = generate_spd_system(N, seed=3)
    files = {"npy": str(d / "A.npy"), "text": str(d / "A.txt")}
    np.save(files["npy"], A)
    save_array(files["text"], A, fmt="%r")
    save_array(str(d / "b.txt"), b, fmt="%r")
    csr = poisson3d_csr(6)
    files["mtx"] = str(d / "P.mtx")
    save_matrix_market(files["mtx"], csr, symmetric=True)
    save_matrix_market(str(d / "Pb.mtx"), np.ones(csr.shape[0], np.float32))
    Aw, bw, _ = random_geometric_spd(1200, seed=3, avg_degree=8.0)
    files["mtx_well"] = str(d / "G.mtx")
    save_matrix_market(files["mtx_well"], Aw, symmetric=True)
    save_matrix_market(str(d / "Gb.mtx"), bw)
    rhs = {"npy": str(d / "b.txt"), "text": str(d / "b.txt"), "mtx": str(d / "Pb.mtx"),
           "mtx_well": str(d / "Gb.mtx")}
    return files, rhs


@pytest.mark.parametrize("kind", ["npy", "text", "mtx", "mtx_well"])
def test_info_spectrum_matches_tpucg_and_gives_its_chebyshev_laps(tmp_path, capsys, kind):
    files, rhs = _spectrum_files(tmp_path)
    specs = []
    for main, extra in ((cli.main, ["--device", "cpu"]), (jcli.main, [])):
        assert main(["info", "--spectrum", files[kind]] + extra) == 0
        specs.append(json.loads(capsys.readouterr().out)["spectrum"])
    ours, theirs = specs
    assert ours["matrix"] == theirs["matrix"] == files[kind]
    scale = SPECTRUM_RTOL * theirs["lam_hi"]
    assert abs(ours["lam_hi"] - theirs["lam_hi"]) <= scale
    assert abs(ours["lam_lo"] - theirs["lam_lo"]) <= scale
    assert ours["lam_hi"] >= ours["lam_lo"] > 0
    assert ours["kappa"] == ours["lam_hi"] / ours["lam_lo"]
    laps = []
    for main, extra, spec in ((cli.main, ["--device", "cpu"], ours), (jcli.main, [], theirs),
                              (jcli.main, [], ours)):
        argv = ["solve", files[kind], rhs[kind], "--method", "chebyshev", "--maxiter", "4000",
                "--interval", repr(spec["lam_lo"]), repr(spec["lam_hi"]),
                "--tol", _rel_tol(rhs[kind])]
        rc = main(argv + extra)
        out = capsys.readouterr().out
        assert rc == 0 and "converged            : True" in out, out
        laps.append(_laps(out))
    assert laps[0] == laps[1] == laps[2], laps


def _rel_tol(path):
    """1e-5 ||b|| of the right-hand side in ``path``."""
    from tpucg_torch.io.mmio import load_matrix_market

    b = load_matrix_market(path) if path.endswith(".mtx") else load_vector(path)
    return repr(1e-5 * float(np.linalg.norm(np.asarray(b).ravel())))


# ---- bench --json and --tol -----------------------------------------------------


def test_bench_json_and_tol_parse_as_tpucgs():
    ours = cli.build_parser().parse_args(["bench", "--json", "--tol", "1e-3", "--devices", "1"])
    theirs = jcli.build_parser().parse_args(["bench", "--json", "--tol", "1e-3",
                                             "--devices", "1"])
    for key in ("json", "tol", "devices"):
        assert getattr(ours, key) == getattr(theirs, key), key
    defaults = cli.build_parser().parse_args(["bench"])
    assert defaults.json is False and defaults.tol is None and defaults.devices is None


def test_bench_report_to_json_has_tpucgs_keys():
    t = Timing(2e-3, 1.9e-3, 2.2e-3, 5)
    rep = BenchReport(n=8192, iterations=4, residual_norm=1e-7, distribute_s=0.1, solve=t,
                      total_s=1.0, card="NVIDIA H100 80GB HBM3, 700.00 W", backend="cuda",
                      padded_n=8192, matvec=Timing(1e-4, 1e-4, 1e-4, 5), nnz=None,
                      strategy="allgather").finalize(3.35e12)
    got = json.loads(rep.to_json())
    assert {f.name for f in dataclasses.fields(JBenchReport)} <= set(got)
    assert got["solve_s"] == 2e-3 and got["matvec_s"] == 1e-4
    assert got["iters_per_s"] == pytest.approx(4 / 2e-3) and got["nnz_per_s"] is None
    assert got["strategy"] == "allgather" and got["device_kind"] == rep.card
    assert got["matvec_gbps"] == rep.matvec_gbps and got["roofline_frac"] == rep.roofline_frac
    sparse = dataclasses.replace(rep, nnz=1000)
    assert json.loads(sparse.to_json())["nnz_per_s"] == pytest.approx(1000 / 1e-4)


# ---- --debug-nans -------------------------------------------------------------


@pytest.fixture
def jax_debug_nans_reset():
    """tpucg's CLI turns jax_debug_nans on and leaves it on: put it back,
    or later tests in this worker run under it."""
    yield
    jax.config.update("jax_debug_nans", False)


def test_debug_nans_raises_floating_point_error_in_both(system, tmp_path, capsys,
                                                         jax_debug_nans_reset):
    b, p, _ = system
    bn = b.copy()
    bn[3] = np.nan
    pn = str(tmp_path / "bn.txt")
    save_array(pn, bn, fmt="%r")
    with pytest.raises(FloatingPointError, match="x and the residual norm"):
        cli.main(["solve", p["A"], pn, "--device", "cpu", "--debug-nans", "--maxiter", "8"])
    with pytest.raises(FloatingPointError):
        jcli.main(["solve", p["A"], pn, "--debug-nans", "--maxiter", "8"])
    jax.config.update("jax_debug_nans", False)
    # The clean system passes; without the flag a NaN b is reported, not raised.
    assert cli.main(["solve", p["A"], p["b"], "--device", "cpu", "--debug-nans"]) == 0
    assert cli.main(["solve", p["A"], pn, "--device", "cpu", "--maxiter", "8"]) == 3
    with pytest.raises(FloatingPointError):
        cli.main(["solve", p["A"], pn, "--device", "cpu", "--debug-nans", "--maxiter", "8",
                  "--strategy", "allgather"])
    capsys.readouterr()


# ---- selftest's mesh checks ---------------------------------------------------


def _selftest_lines(out):
    return {name: next(ln for ln in out.splitlines() if name in ln)
            for name in ("sharded[allgather]", "sharded[overlap]", "] pipelined")}


def test_selftest_runs_tpucgs_mesh_checks(capsys):
    assert cli.main(["selftest", "--device", "cpu", "--n", "64"]) == 0
    out = capsys.readouterr().out
    assert "all selftests passed" in out
    for name, line in _selftest_lines(out).items():
        assert line.lstrip().startswith("[ok]"), line
    assert "(1 ranks)" in out


def test_selftest_on_a_world_of_two(world2):
    rc, out = world2["selftest"]
    assert rc == 0 and "all selftests passed" in out, out
    assert "(2 ranks)" in _selftest_lines(out)["sharded[allgather]"]
