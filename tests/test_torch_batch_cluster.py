"""K5's cluster plan (``tpucg_torch.kernels.fused.batch_cluster_plan``) on
the CPU: the cluster size C a batch gets, the blocks' threads and shared
bytes, which block owns each row of A and each element, and K5's scalar
reductions emulated in float32 NumPy (per virtual warp, across the blocks'
slots, then the 32-value tree), bit-equal for every C to the one-block
order. K5 itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tpucg_torch.kernels.fused import (
    BATCH_MAX_CLUSTER,
    BATCH_ROW_CHUNKS,
    BATCH_SMS,
    BATCH_THREADS,
    FUSED_BATCH_MAX_N,
    batch_cluster_plan,
    fused_batch_cg_solve_cuda,
)

CSRC = Path(__file__).resolve().parents[1] / "tpucg_torch" / "kernels" / "csrc"

# The card's shared memory (hopper-kernels: H100 SXM): 228 KB an SM, 1 KB of
# it kept by the runtime for each resident block; a block takes 48 KB
# without asking (K5's launch does not ask).
SM_SMEM = 233_472
SMEM_DEFAULT = 48 * 1024
BLOCK_RESERVED = 1024
SM_THREADS = 2048
STATIC_SMEM = 2 * 2 * 32 * 4  # K5's slots: [p.Ap | r.r, r.z][sum][virtual warp], f32
MIN_BLOCKS = 2  # K5's launch bounds for C >= 2: two blocks an SM

BATCHES = (1, 2, 15, 16, 17, 33, 64, 65, 131, 132, 133, 256, 1024)
NPADS = (128, 512, 1024, 2048)
CLUSTERS = (1, 2, 4, 8)


@pytest.mark.parametrize("npad", NPADS)
@pytest.mark.parametrize("batch", BATCHES)
def test_plan_takes_the_least_cluster_that_fills_the_card(batch, npad):
    plan = batch_cluster_plan(batch, npad)
    C = plan.cluster
    assert C in CLUSTERS and (plan.batch, plan.npad) == (batch, npad)
    # One block a system once it holds half the SMs (a cluster of 2 never
    # beat it there); below, the least C of 4 and 8 that fills the card.
    assert (C == 1) == (2 * batch >= BATCH_SMS) and C != 2
    assert batch * C >= BATCH_SMS or C in (1, BATCH_MAX_CLUSTER)
    assert C in (1, 4) or batch * (C // 2) < BATCH_SMS  # the least such C
    assert plan.threads == BATCH_THREADS // C and plan.warps == plan.threads // 32
    assert plan.blocks == batch * C
    assert plan.loads == {1: 4, 2: 8, 4: 8, 8: BATCH_ROW_CHUNKS}[C]
    # The block's shared bytes fit without an opt-in, and at C >= 2 two
    # blocks (the launch bounds' minimum) fit an SM by shared bytes and
    # threads.
    block = plan.smem_bytes + STATIC_SMEM
    assert plan.smem_bytes == 20 * npad and block <= SMEM_DEFAULT
    if C > 1:
        assert MIN_BLOCKS * (block + BLOCK_RESERVED) <= SM_SMEM
        assert MIN_BLOCKS * plan.threads <= SM_THREADS


@pytest.mark.parametrize("npad", NPADS)
@pytest.mark.parametrize("cluster", CLUSTERS)
def test_every_row_and_element_has_one_owning_block(cluster, npad):
    plan = batch_cluster_plan(16, npad, cluster=cluster)
    T, W = plan.threads, plan.warps
    rows, elems = [], []
    for q in range(cluster):
        # The kernel's loops: virtual warp q W + w walks rows vw, vw + 32,
        # ...; virtual thread q T + t walks elements vt, vt + 1024, ...
        r = [row for w in range(W) for row in range(q * W + w, npad, 32)]
        e = [i for t in range(T) for i in range(q * T + t, npad, BATCH_THREADS)]
        assert all(plan.row_owner(row) == q for row in r)
        assert all(plan.element_owner(i) == q for i in e)
        # Virtual warp r % 32, virtual thread i % 1024.
        assert all((row % 32) - q * W in range(W) for row in r)
        assert all((i % BATCH_THREADS) - q * T in range(T) for i in e)
        rows += r
        elems += e
    assert sorted(rows) == list(range(npad)) and sorted(elems) == list(range(npad))
    i = np.arange(npad)
    assert np.array_equal(plan.row_owner(i), (i % 32) // W)
    assert np.array_equal(plan.element_owner(i), (i % BATCH_THREADS) // T)


def test_plan_refuses_what_k5_cannot_run():
    for batch, npad in ((0, 128), (4, 100), (4, 0), (4, FUSED_BATCH_MAX_N + 128)):
        with pytest.raises(ValueError, match="cannot plan"):
            batch_cluster_plan(batch, npad)
    for cluster in (0, 3, 16):
        with pytest.raises(ValueError, match="1, 2, 4 or 8"):
            batch_cluster_plan(4, 128, cluster=cluster)
    assert batch_cluster_plan(500, 128, cluster=8).cluster == 8  # forced, not planned


def test_plan_follows_the_cards_sm_count():
    assert batch_cluster_plan(64, 1024, sms=132).cluster == 4
    assert batch_cluster_plan(64, 1024, sms=128).cluster == 1
    assert batch_cluster_plan(64, 1024, sms=200).cluster == 4
    assert batch_cluster_plan(64, 1024, sms=300).cluster == 8
    assert batch_cluster_plan(16, 2048).cluster == 8
    assert batch_cluster_plan(256, 512).cluster == 1
    assert [batch_cluster_plan(b, 1024).cluster for b in (32, 33, 65, 66)] == [8, 4, 4, 1]


@pytest.mark.parametrize("cluster", CLUSTERS)
def test_wrapper_on_cpu_tensors_needs_the_card(cluster):
    A = torch.eye(128).expand(2, 128, 128).contiguous()
    v = torch.zeros(2, 128)
    with pytest.raises(ValueError, match="CUDA device"):
        fused_batch_cg_solve_cuda(A, v, v, tol=1e-6, maxiter=4, _cluster=cluster)


def test_plan_constants_are_the_kernels():
    src = (CSRC / "fused.cu").read_text()
    header = (CSRC / "blas.cuh").read_text()
    assert re.search(rf"constexpr int kFusedBatchMaxN = {FUSED_BATCH_MAX_N};", header)
    assert re.search(rf"constexpr int kBatchBlock = {BATCH_THREADS};", src)
    assert re.search(rf"constexpr int kBatchMaxCluster = {BATCH_MAX_CLUSTER};", src)
    assert "constexpr int kBatchRowChunks = kFusedBatchMaxN / 128;" in src
    assert ("constexpr int U = C == 1 ? 4 : C == kBatchMaxCluster ? kBatchRowChunks : 8;"
            in src)
    assert "constexpr int T = kBatchBlock / C;" in src
    assert re.search(r"__launch_bounds__\(kBatchBlock / C, C == 1 \? 1 : 2\)\s*\n"
                     r"fused_batch_cg_kernel\(", src)
    assert "__shared__ float slots[2][2][32];" in src  # STATIC_SMEM
    assert "cfg.dynamicSmemBytes = 5 * static_cast<size_t>(n) * sizeof(float);" in src
    # One kernel per C, launched with a cluster dimension; a refused
    # cluster is an error, never a smaller C.
    for c in ("1", "2", "4", "kBatchMaxCluster"):
        assert f"case {c}: return launch_fused_batch<{c}>(ba, batch, stream);" in src
    assert "cudaLaunchAttributeClusterDimension" in src
    assert "cudaOccupancyMaxActiveClusters(clusters, fused_batch_cg_kernel<C>, &cfg)" in src
    assert "if (clusters < 1) return cudaErrorInvalidClusterSize;" in src
    assert "atomicAdd" not in src


def shfl_down_tree(v: np.ndarray) -> np.float32:
    """A warp's shuffle-down tree over its 32 lanes' f32 values: lane 0's
    result (a lane whose source lies past 31 adds its own value; lane 0
    never reads one)."""
    v = v.astype(np.float32).copy()
    for off in (16, 8, 4, 2, 1):
        src = np.concatenate([v[off:], v[32 - off:]])  # lanes >= 32 - off read their own
        v = (v + src).astype(np.float32)
    return v[0]


def thread_sums(terms: np.ndarray) -> np.ndarray:
    """Each of the 1024 virtual threads' running f32 sum of the terms of its
    elements v, v + 1024, ... in order."""
    npad = terms.shape[0]
    s = np.zeros(BATCH_THREADS, np.float32)
    for j in range(0, npad, BATCH_THREADS):
        chunk = terms[j:j + BATCH_THREADS]
        s[:len(chunk)] = (s[:len(chunk)] + chunk).astype(np.float32)
    return s


def warp_lane0_sums(p: np.ndarray, ap: np.ndarray) -> np.ndarray:
    """p.Ap's per-thread values: lane 0 of virtual warp w holds the running
    f32 sum of p_r Ap_r over its rows w, w + 32, ... in order, other lanes
    0."""
    npad = p.shape[0]
    s = np.zeros(BATCH_THREADS, np.float32)
    for w in range(32):
        acc = np.float32(0)
        for r in range(w, npad, 32):
            acc = np.float32(acc + np.float32(p[r] * ap[r]))
        s[32 * w] = acc
    return s


def one_block_sum(vals: np.ndarray) -> np.float32:
    """The one-block order (block_allsum over 32 warps): each warp's tree,
    then the tree over the 32 warp sums in warp order."""
    return shfl_down_tree(np.array([shfl_down_tree(vals[32 * w:32 * w + 32])
                                    for w in range(32)], np.float32))


def cluster_sums(vals: np.ndarray, cluster: int) -> list:
    """K5's cluster reduction of the virtual threads' values: block q's
    thread t holds vals[q T + t]; each of its W warps' trees goes into slot
    q W + w of every block's 32 slots; then every block sums its 32 slots in
    one tree. Returns each block's result."""
    T = BATCH_THREADS // cluster
    W = T // 32
    slots = [np.full(32, np.nan, np.float32) for _ in range(cluster)]
    for q in range(cluster):
        local = vals[q * T:(q + 1) * T]
        for w in range(W):
            s = shfl_down_tree(local[32 * w:32 * w + 32])
            for dst in range(cluster):
                slots[dst][q * W + w] = s
    assert not any(np.isnan(s).any() for s in slots)  # every slot written
    return [shfl_down_tree(s) for s in slots]


@pytest.mark.parametrize("npad", (128, 1024, 2048))
@pytest.mark.parametrize("seed", (0, 1, 2))
def test_emulated_reductions_recombine_bit_for_bit(seed, npad):
    rng = np.random.default_rng(seed)
    # Terms of mixed sign and size, so that the order of summation shows.
    r = (rng.standard_normal(npad) * 10.0 ** rng.integers(-3, 4, npad)).astype(np.float32)
    p = rng.standard_normal(npad).astype(np.float32)
    ap = (rng.standard_normal(npad) * 10.0 ** rng.integers(-3, 4, npad)).astype(np.float32)
    rr_vals = thread_sums((r * r).astype(np.float32))
    pap_vals = warp_lane0_sums(p, ap)
    for vals in (rr_vals, pap_vals):
        want = one_block_sum(vals)
        for cluster in CLUSTERS:
            got = cluster_sums(vals, cluster)
            assert all(g.tobytes() == want.tobytes() for g in got), (cluster, got, want)
