"""dtype="float64" on CUDA: the float64 family of the fused-likelihood
kernels (``clonealign_torch/ops/csrc/fused_likelihood_f64.cu``) and the
paths it opens.

On the CPU: ``f64_plan`` (every column of each kernel in one group or pass,
the caps, the chunks within grid.y, every bound; the plan and workspace the
wrappers hand the library, with the library's entry points recorded, not
called, and each call routed by its compute dtype), a numpy emulation of
the kernels' order of work (the forward's column groups over [YW | A2 | Z],
dpsi's dZ groups with dA1 YW added last, the gene part's passes and its
chunks' partial sums folded in chunk order; past the old bound the split
forward's, dpsi's and gene part's row blocks, gene ranges and slices)
against the plain float64 VJP and (past the bound) against the JAX
package's plain float64 terms and their VJP,
``restarts._sweep_bytes`` at itemsize 8, the float64 plain versions against
the JAX package's exact float64 likelihood and its VJP (``jax.vjp``, x64)
for each Y type, and ``run_clonealign(restart_batching="vmap")`` in float64
against the JAX package's sweep on replayed draws (``fit_streaming`` and
``inference_em`` in float64 are held to the JAX package by
tests/test_torch_stream.py and tests/test_torch_negbin.py). On the card
(``cuda`` marker, skipped without a GPU): the float64 kernels against the
plain versions for every Y type, each kernel
bit-identical across launches, a float64 ``clonealign`` on CUDA equal to
the CPU's from the same draws, and the mixed-dtype refusals:
``python -m pytest --noconftest -m cuda tests/test_torch_float64.py``.

Tolerance of the kernels (and of the emulation): each element within
ABS_RTOL = 1e-12 of the sum of its terms' absolute values. Both sides sum in
float64 in other orders; 1e-12 of the absolute sum is about 4,500 float64
ulps of it, while one term of 5,000 left out is about 2e-4 of it.

jax is imported inside fixtures and tests, never at the top: the GPU
machine has no jax.
"""

import ctypes

import numpy as np
import pytest
import torch

import clonealign_torch as ct
from clonealign_torch import restarts as trestarts
from clonealign_torch.models import multinomial as tmm
from clonealign_torch.ops import fused_likelihood as tfl
from clonealign_torch.synth import simulate_multinomial

torch.set_num_threads(2)

F64 = torch.float64
ABS_RTOL = 1e-12
STORAGES = [torch.float64, torch.bfloat16, torch.int16, torch.int8]
# (N, G, C, K, S), K the columns of [psi, X]: the ragged and vectorized
# shapes, rich, the wide checks, three 1,024-cell chunks, one gene and
# K = 0, every bound at once (Kf 64, S 64, S*C 2048), S*C 2048 in dpsi's
# 26 groups at Kf 1, and Kf 9 (dpsi's log_rfe by MMA), N and G off every
# tile size
SHAPES = [(37, 41, 2, 1, 1), (45, 260, 4, 3, 1), (200, 96, 3, 4, 3), (100, 129, 10, 5, 1),
          (100, 129, 33, 1, 1), (100, 129, 4, 1, 5), (100, 129, 12, 6, 8)]
CUDA_SHAPES = SHAPES + [(2000, 500, 3, 4, 3), (1000, 515, 12, 6, 8), (2100, 130, 9, 1, 4),
                        (33, 1, 40, 0, 1), (300, 100, 32, 64, 64), (130, 77, 2048, 1, 1),
                        (90, 37, 5, 9, 2)]
# past the old bound of 64, 64 and 2,048, each alone and all at once (as
# tests/test_torch_wide.py's PAST_BOUND_SHAPES), Kf 136 and 300 (past the
# grouped forward's 139), and K 0 at S*C 2,178 (the forward's empty Y tile)
PAST_BOUND_SHAPES = [(300, 100, 3, 72, 2), (300, 100, 2, 1, 66), (2100, 200, 66, 1, 33),
                     (200, 70, 10, 72, 66), (100, 60, 3, 136, 1), (100, 60, 3, 300, 1),
                     (300, 100, 33, 0, 66)]
CUDA_SHAPES += PAST_BOUND_SHAPES


def _inputs(N, G, C, K, S, seed):
    """Y, psi, W, log_mu, muL as float64 numpy arrays (the recipe of
    tests/test_torch_wide.py): Poisson(3) counts, exact in every storage."""
    rng = np.random.default_rng(seed)
    Y = rng.poisson(3.0, (N, G)).astype(np.float64)
    psi = rng.normal(0, 1, (N, K))
    W = rng.normal(0, 0.3 / np.sqrt(max(K, 1)), (G, K))
    mu = rng.lognormal(0, 0.5, (S, G))
    L = rng.integers(1, 5, (G, C)).astype(np.float64)
    muL = (mu[:, None, :] * L.T[None]).transpose(2, 0, 1).reshape(G, S * C)
    return Y, psi, W, np.log(mu), np.ascontiguousarray(muL)


def _cotangents(N, S, SC, seed):
    rng = np.random.default_rng(seed + 1000)
    return rng.normal(size=N), rng.normal(size=(N, S)), rng.normal(size=(N, SC))


def _scales(Y, psi, W, log_mu, muL, dA1, dA2, dZ):
    """Each output's sum of its terms' absolute values (numpy, float64)."""
    log_rfe = psi @ W.T
    rfe = np.exp(log_rfe)
    dlog = Y * np.abs(dA1)[:, None] + rfe * (np.abs(dZ) @ muL.T)
    return {"A1": (Y * np.abs(log_rfe)).sum(1), "A2": Y @ np.abs(log_mu).T, "Z": rfe @ muL,
            "YW": Y @ np.abs(W), "dpsi": dlog @ np.abs(W), "dW": dlog.T @ np.abs(psi),
            "dlog_mu": np.abs(dA2).T @ Y, "dmuL": rfe.T @ np.abs(dZ)}


def _assert_within(got, want, scale, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    err = np.abs(got - want)
    assert (err <= ABS_RTOL * scale).all(), (
        f"{name}: max err / scale {(err / np.maximum(scale, 1e-300)).max():.3e}")


def _t(a, dtype=F64, device="cpu"):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)


# --- the plan ----------------------------------------------------------------

# (N, G, Kf, n_a2, SC): the main path's widths, with A2, the wide fit's,
# every bound (small and at full width), Kf = 0 with one gene, a fit past
# 65,535 chunks of 1,024 cells, and groups that split unevenly
PLAN_SHAPES = [(100_000, 5_000, 1, 0, 10), (100_000, 5_000, 1, 1, 10), (100_000, 5_000, 5, 0, 80),
               (100_000, 5_000, 5, 8, 80), (300, 100, 64, 64, 2048),
               (100_000, 5_000, 64, 64, 2048), (33, 1, 0, 0, 40), (100_000_000, 10, 1, 0, 10),
               (1000, 515, 6, 8, 96), (2100, 130, 1, 4, 36), (37, 41, 1, 1, 2)]


def _groups(n, groups, cols):
    return [list(range(q * cols, min(n, (q + 1) * cols))) for q in range(groups)]


# ... and past the old bound (the split forward, dpsi and gene part): one
# row block with its cells in slices, Kf 72 / S 66 / S*C 660 at full width
# (121 row blocks of 832 cells, Z's product in 5 gene ranges, dpsi's in
# 14), every bound at once, two row blocks at 45,000 x 100, Kf 139 (the
# widest the grouped forward took) and 300, Kf 0 (the forward's one empty
# Y tile), three gene ranges of 192 at 1,000 x 515, and an odd S*C and Kf
PAST_PLAN_SHAPES = [(300, 100, 72, 2, 6), (300, 100, 1, 66, 132), (2100, 200, 1, 33, 2178),
                    (100_000, 5_000, 72, 0, 660), (100_000, 5_000, 72, 66, 660),
                    (600, 200, 72, 66, 2178), (45_000, 100, 72, 66, 660), (1000, 500, 139, 0, 10),
                    (300, 100, 0, 0, 2178), (1000, 515, 72, 0, 6), (700, 300, 73, 0, 2049),
                    (200, 100, 300, 0, 10)]


def _wave_fill(tiles, z, slots=3 * 132):
    """The share of its last wave of ``slots`` blocks that ``tiles`` blocks
    in each of z gene ranges fill."""
    return tiles * z / (-(-tiles * z // slots) * slots)


@pytest.mark.parametrize("shape", PLAN_SHAPES + PAST_PLAN_SHAPES)
def test_f64_plan_covers_every_column_once_within_every_bound(shape):
    """The forward's column groups hold each 8-column tile of [YW | A2 | Z]
    once (the Y products' tiles first), the gene part's passes each tile of
    [dlog mu | d(muL)] once, dpsi's groups each of dZ's columns once; every
    group or pass non-empty, within its built tile count (the least built
    count that holds it; the gene part's beside dW's tiles, which hold
    every column of [psi, X]) and one group or pass wherever the largest
    count allows; dpsi's dZ tiles split evenly into groups of its built
    count (each of dZ's columns once, in one group up to S*C 80), its
    built count of [psi, X]'s tiles holding every column once (one tile up
    to Kf 8, where log_rfe takes FMAs); the blocks cover the cells and
    genes, the chunks are whole gene-part stages that cover the cells with
    grid.y within 65,535; each kernel's shared memory is its layout's and
    within the card's (dpsi's within two blocks an SM, with 4 k-steps a
    stage wherever they fit); the workspace is the packed tables, and the
    partial sums of every chunk beside the output. Past the old bound the
    forward, dpsi and the gene part are the split ones: the forward's
    groups hold only the Y products' tiles (at least one, so that a launch
    has a group at Kf 0 without A2) and no psi or W, the row blocks hold
    each cell once, in whole tiles of
    64 as even as they go, each at most 2^22 doubles of rfe past one tile
    (half the float32 plan's cells), the workspace's row pitch an even
    count of at least G, a single row block's slices each cell once in
    whole stages of 32 where its blocks would not fill three an SM twice
    over, Z's and dpsi's products' gene ranges each gene once in whole
    stages of 32, the fewest that fill their last wave of three blocks an
    SM on 132 SMs to 0.9 where any count (of 256 genes or more) can, the
    grouped dpsi's and gene part's keys 0, and the workspaces: the
    forward's table, row block of rfe and Z's ranges' sums, dpsi's row
    block of t and its ranges' sums, the gene part's (and the one call's)
    slices' partial sums, row block of rfe and dlog_rfe, dpsi's ranges'
    sums and the output."""
    N, G, Kf, n_a2, SC = shape
    p = tfl.f64_plan(N, G, Kf, n_a2, SC)
    F = Kf + n_a2 + SC
    split = Kf > 64 or n_a2 > 64 or SC > 2048
    assert p["split"] == int(split)
    if split:
        assert p["f_yt"] == max(1, -(-(Kf + n_a2) // 8)) and p["f_tiles"] == p["f_yt"]
    else:
        assert p["f_yt"] == -(-(Kf + n_a2) // 8) and p["f_tiles"] == p["f_yt"] + -(-SC // 8)
    groups = [(p["f_tiles"], p["f_groups"], p["f_count"], p["f_nt"], tfl.F64_FWD_TILE_COUNTS)]
    if not split:
        assert p["g_st"] == -(-n_a2 // 8) and p["g_tiles"] == p["g_st"] + -(-SC // 8)
        assert 8 * p["g_nk"] >= Kf and p["g_nk"] in tfl.F64_GENE_K_COUNTS
        assert p["g_nk"] == min(k for k in tfl.F64_GENE_K_COUNTS if 8 * k >= max(Kf, 1))
        groups.append((p["g_tiles"], p["g_passes"], p["g_count"], p["g_nt"],
                       tfl.F64_GENE_TILE_COUNTS[p["g_nk"]]))
    for n, n_groups, cols, nt, counts in groups:
        split_cols = _groups(n, n_groups, cols)
        assert sum(split_cols, []) == list(range(n))
        assert all(split_cols) and cols <= nt and nt == min(c for c in counts if c >= cols)
        assert (n_groups == 1) == (n <= counts[-1])
    assert p["f_blocks"] * 16 * tfl.F64_FWD_WARPS >= N > (p["f_blocks"] - 1) * 16 * tfl.F64_FWD_WARPS
    assert p["n_chunks"] * p["rows"] >= N > (p["n_chunks"] - 1) * p["rows"]
    assert p["n_chunks"] <= 65535 and p["f_groups"] <= 65535
    klr = 0 if split else Kf  # psi's and W's columns the forward holds for log_rfe
    assert p["f_smem"] == (8 * (16 * tfl.F64_FWD_WARPS * klr
                                + 2 * tfl.F64_FWD_GENES * (8 * p["f_nt"] + klr))
                           + 2 * tfl.F64_FWD_Y_STAGE_BYTES)
    # the packed tables: per 32-gene stage 4 k-steps of every tile's 32 B
    # pairs and W's 4 pairs a column
    assert p["f_table"] == 2 * -(-G // 32) * 4 * (32 * p["f_tiles"] + 4 * klr)
    assert max(p["f_smem"], p["d_smem"], p["g_smem"]) <= tfl.F64_MAX_SMEM
    if split:
        rows, blocks = p["rows"], p["n_chunks"]
        cells = [n for b in range(blocks) for n in range(b * rows, min(N, (b + 1) * rows))]
        assert cells == list(range(N)) and rows % 64 == 0 and rows - -(-N // blocks) < 64
        assert p["ldw"] >= G and p["ldw"] % 2 == 0 and p["ldw"] - G < 2
        assert rows * p["ldw"] <= max(64 * p["ldw"], 1 << 22)
        assert not any(p[k] for k in ("d_nk", "d_nz", "d_groups", "d_steps", "d_blocks", "d_smem",
                                      "d_table", "g_st", "g_tiles", "g_nk", "g_count", "g_nt",
                                      "g_passes", "g_blocks", "g_smem", "g_table"))
        products = -(-G // 64) * (-(-Kf // 64) + -(-SC // 64))
        if p["gslices"] > 1:  # one row block's cells in slices of whole stages
            assert blocks == 1 and p["gcells"] % 32 == 0 and products < 2 * 3 * 132
            assert [n for z in range(p["gslices"])
                    for n in range(z * p["gcells"], min(N, (z + 1) * p["gcells"]))] == cells
        else:
            assert p["gcells"] == rows and (blocks > 1 or products >= 2 * 3 * 132
                                            or N <= 256)
        # Z's and dpsi's gene ranges: each gene once, whole stages of 32,
        # the wave filled to 0.9 where a count of ranges of 256 genes or
        # more can
        for n, genes, tiles in ((p["zsplit"], p["zgenes"], -(-rows // 64) * -(-SC // 64)),
                                (p["dsplit"], p["dgenes"], -(-rows // 64) * -(-max(Kf, 1) // 64))):
            assert genes % 32 == 0 and [g for z in range(n)
                                        for g in range(z * genes, min(G, (z + 1) * genes))] == \
                list(range(G))
            counts = range(1, max(1, -(-G // 256)) + 1)
            best = max(_wave_fill(tiles, z) for z in counts)
            fewest = min((z for z in counts if _wave_fill(tiles, z) >= 0.9), default=None)
            assert _wave_fill(tiles, n) >= min(0.9, best) - 1e-12
            assert fewest is None or n <= fewest + 1
        part = p["gslices"] * F * G + (p["gslices"] * F * G) % 2 if p["gslices"] > 1 else 0
        assert p["part"] == part
        block, dpart = rows * p["ldw"], p["dsplit"] * rows * Kf
        zpart = p["zsplit"] * rows * SC + (p["zsplit"] * rows * SC) % 2 if p["zsplit"] > 1 else 0
        # A1's partial sums: a row's over each 32 genes
        assert p["fwd_workspace"] == p["f_table"] + block + zpart + rows * 2 * -(-G // 64)
        assert p["dpsi_workspace"] == block + dpart
        assert p["gene_workspace"] == p["bwd_workspace"] == part + 2 * block + dpart + F * G
        return
    # dpsi: group q takes dZ's tiles [q d_nz, (q + 1) d_nz), each tile's 8
    # columns (those past S*C zero), every group holding a column
    nz, zt = p["d_nz"], -(-SC // 8)
    dz_cols = [[j for j in range(8 * q * nz, 8 * (q + 1) * nz) if j < SC]
               for q in range(p["d_groups"])]
    assert sum(dz_cols, []) == list(range(SC)) and all(dz_cols)
    assert nz == min(c for c in tfl.F64_DPSI_Z_COUNTS if c >= -(-zt // p["d_groups"]))
    assert p["d_groups"] == -(-zt // tfl.F64_DPSI_Z_COUNTS[-1])
    assert (p["d_groups"] == 1) == (SC <= 80)
    psi_cols = [k for kc_ in range(p["d_nk"]) for k in range(8 * kc_, 8 * kc_ + 8) if k < Kf]
    assert psi_cols == list(range(Kf))
    assert p["d_nk"] == min(k for k in tfl.F64_DPSI_K_COUNTS if 8 * k >= max(Kf, 1))
    dl = 16 * tfl.F64_DPSI_WARPS
    assert p["d_blocks"] * dl >= N > (p["d_blocks"] - 1) * dl
    assert p["fwd_workspace"] == p["f_table"] and p["dpsi_workspace"] == p["d_table"]
    lr_tiles = p["d_nk"] if p["d_nk"] > 1 else 0  # log_rfe's W^T tiles (MMAs past Kf 8)
    d_tiles = nz + p["d_nk"] + lr_tiles  # a stage's tiles a k-step

    def dpsi_smem(steps):  # the warps' psi (2 d_nk tiles each), two stages
        return 16 * 32 * (tfl.F64_DPSI_WARPS * 2 * p["d_nk"] + 2 * steps * d_tiles)

    assert p["d_smem"] == dpsi_smem(p["d_steps"]) <= tfl._TWO_BLOCK_SMEM
    assert p["d_steps"] == (4 if dpsi_smem(4) <= tfl._TWO_BLOCK_SMEM else 2)
    # per k-step of 8 genes (G padded to whole stages) every group's muL^T
    # tiles, dpsi's W tiles and log_rfe's, 32 pairs each
    g_pad = -(-G // (8 * p["d_steps"])) * 8 * p["d_steps"]
    assert p["d_table"] == 2 * (g_pad // 8) * 32 * (p["d_groups"] * nz + p["d_nk"] + lr_tiles)
    gl = 16 * tfl.F64_GENE_WARPS
    assert p["g_blocks"] * gl >= G > (p["g_blocks"] - 1) * gl
    assert p["rows"] % tfl.F64_GENE_CELLS == 0 and p["rows"] >= 1024
    assert p["g_smem"] == (8 * (16 * tfl.F64_GENE_WARPS * Kf
                                + 2 * (tfl.F64_GENE_CELLS * (16 * p["g_nt"] + 8 * p["g_nk"] + Kf)
                                       + tfl.F64_GENE_CELLS))
                           + 2 * tfl.F64_GENE_Y_STAGE_BYTES)
    assert p["part"] == p["n_chunks"] * F * G + (p["n_chunks"] * F * G) % 2  # table aligned
    # per 32-cell stage 4 n-tiles of drfe's and the tiles' 32 pairs each,
    # dW's, psi's 4 a column, and dA1
    assert p["g_table"] == 2 * -(-N // 32) * (4 * (32 * (2 * p["g_tiles"] + p["g_nk"]) + 4 * Kf)
                                            + 16)
    assert p["gene_workspace"] == p["part"] + p["g_table"] + F * G
    assert p["bwd_workspace"] == p["gene_workspace"] + (p["dpsi_workspace"] if Kf else 0)
    assert not any(p[k] for k in ("split", "ldw", "gslices", "gcells", "dsplit", "dgenes",
                                  "zsplit", "zgenes"))


class _FakeLib:
    """The CUDA library's entry points, recording their arguments."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def call(*args):
            self.calls[name] = args
            return 0
        return call


@pytest.mark.parametrize("shape", [(2100, 130, 9, 1, 4), (70, 300, 10, 6, 8), (40, 70, 3, 64, 64),
                                   (40, 70, 10, 72, 66), (2100, 200, 66, 1, 33),
                                   (60, 50, 33, 0, 66), (300, 100, 2, 1, 66)])
def test_f64_plan_is_what_the_wrappers_hand_the_library(monkeypatch, shape):
    """Float64 operands go to the fl64_* entry points with f64_plan's
    numbers in F64_PLAN_KEYS' order and Y's code in Y_DTYPES_F64, the
    outputs, kernel_forward's workspace (its fwd_workspace: past the old
    bound with the row block's rfe, Z's ranges' sums and A1's partial
    sums), kernel_dpsi's (its dpsi_workspace) and kernel_gene's scratch in
    float64, kernel_gene's allocations adding up to the plan's
    gene_workspace (past the old bound the split gene part's: the slices'
    partial sums where a single row block's cells go in slices, then the
    row block's rfe and dlog_rfe, rows x ldw each, and dpsi's ranges'
    sums), each launch counted in *_f64_launches and in no float32 count;
    kernel_backward past the old bound one fl64_backward_gene call with
    dpsi (its bwd_workspace), counted once in split_f64_launches and in no
    other count, and within it kernel_dpsi's and kernel_gene's calls (dpsi
    null); float32 operands still go to the float32 entry points. The
    wrappers run on CPU tensors with the library recorded, not called."""
    N, G, C, K, S = shape
    Y, psi, W, log_mu, muL = map(_t, _inputs(N, G, C, K, S, seed=1))
    dA1, dA2, dZ = map(_t, _cotangents(N, S, S * C, seed=1))
    lib = _FakeLib()
    from clonealign_torch.ops import _build
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(tfl, "_check", lambda *args, **kwargs: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    allocated = []
    empty = torch.empty

    def recording_empty(*shape_, **kwargs):
        out = empty(*shape_, **kwargs)
        allocated.append(out)
        return out

    monkeypatch.setattr(torch, "empty", recording_empty)
    tfl.reset_launch_counts()
    F = K + S * C
    for with_a2 in (True, False):
        n_a2 = S if with_a2 else 0
        p = tfl.f64_plan(N, G, K, n_a2, S * C)
        want = [p[k] for k in tfl.F64_PLAN_KEYS]
        for storage in STORAGES:
            allocated.clear()
            tfl.kernel_gene(Y.to(storage), psi, W, muL, dA1, dA2 if with_a2 else None, dZ)
            assert sum(t.numel() for t in allocated) == p["gene_workspace"]
            assert all(t.dtype == F64 for t in allocated)
            assert [t.numel() for t in allocated] == [p["gene_workspace"] - (F + n_a2) * G,
                                                      (F + n_a2) * G]
            if p["split"]:
                assert p["gene_workspace"] - (F + n_a2) * G == (
                    p["part"] + 2 * p["rows"] * p["ldw"] + p["dsplit"] * p["rows"] * K)
                assert p["part"] == (0 if p["gslices"] == 1
                                     else 2 * -(-p["gslices"] * (F + n_a2) * G // 2))
            args = lib.calls.pop("fl64_backward_gene")
            assert args[7] is None  # no dpsi
            assert list(args[10]) == want and args[-2] == tfl.Y_DTYPES_F64[storage]
            assert len(want) == len(tfl.F64_PLAN_KEYS) == 35
            allocated.clear()
            tfl.kernel_forward(Y.to(storage), psi, W, log_mu if with_a2 else None, muL)
            assert [t.shape for t in allocated] == [(N,), *([(N, S)] if with_a2 else []),
                                                    (N, S * C), (N, K), (p["fwd_workspace"],)]
            assert all(t.dtype == F64 for t in allocated)
            args = lib.calls.pop("fl64_forward")
            assert args[9].value == allocated[-1].data_ptr() or allocated[-1].numel() == 0
            assert list(args[10]) == want and args[-2] == tfl.Y_DTYPES_F64[storage]
    allocated.clear()
    tfl.kernel_dpsi(psi, W, muL, dA1, dZ, _t(np.zeros((N, K))))
    if K:
        args = lib.calls.pop("fl64_backward_dpsi")
        p = tfl.f64_plan(N, G, K, 0, S * C)
        assert list(args[8]) == [p[k] for k in tfl.F64_PLAN_KEYS]
        assert [t.shape for t in allocated] == [(N, K), (p["dpsi_workspace"],)]
        assert all(t.dtype == F64 for t in allocated)
        assert args[7].value == allocated[-1].data_ptr()
    counts = (tfl.fwd_f64_launches, tfl.dpsi_f64_launches, tfl.gene_f64_launches,
              tfl.split_f64_launches)
    assert counts == (2 * len(STORAGES), int(K > 0), 2 * len(STORAGES), 0)
    assert not lib.calls
    # the autograd function's backward: past the old bound one call for
    # dpsi and the gene part, else kernel_dpsi's and kernel_gene's
    for with_a2 in (True, False):
        n_a2 = S if with_a2 else 0
        p = tfl.f64_plan(N, G, K, n_a2, S * C)
        tfl.reset_launch_counts()
        allocated.clear()
        YW = _t(np.zeros((N, K)))
        tfl.kernel_backward(Y.to(torch.int8), psi, W, muL, dA1, dA2 if with_a2 else None, dZ, YW)
        if p["split"]:
            args = lib.calls.pop("fl64_backward_gene")
            assert [t.shape for t in allocated] == [(N, K), (p["bwd_workspace"] - (F + n_a2) * G,),
                                                    (F + n_a2, G)]
            assert args[7].value == allocated[0].data_ptr() or K == 0
            assert args[8].value == allocated[1].data_ptr() or allocated[1].numel() == 0
            assert list(args[10]) == [p[k] for k in tfl.F64_PLAN_KEYS]
            assert args[-2] == tfl.Y_DTYPES_F64[torch.int8]
            counts = (0, 0, 0, 1)
        else:
            assert lib.calls.pop("fl64_backward_gene")[7] is None
            assert (lib.calls.pop("fl64_backward_dpsi", None) is None) == (K == 0)
            counts = (0, int(K > 0), 1, 0)
        assert not lib.calls
        assert (tfl.fwd_f64_launches, tfl.dpsi_f64_launches, tfl.gene_f64_launches,
                tfl.split_f64_launches) == counts
        assert (tfl.fwd_launches, tfl.dpsi_launches, tfl.gene_launches, tfl.fwd_wide_launches,
                tfl.dpsi_wide_launches, tfl.gene_wide_launches, tfl.split_launches) == (0,) * 7
    # float32 operands: the float32 family's entry points, as before
    f32 = [t.float() for t in (Y, psi, W, muL)]
    tfl.kernel_forward(f32[0], f32[1], f32[2], None, f32[3])
    assert set(lib.calls) == {"fl_forward_wide" if tfl.wide_route(K, 0, S * C) else "fl_forward"}
    tfl.reset_launch_counts()


def test_compute_dtype_is_float32_or_float64():
    assert tfl._compute_dtype(torch.zeros(2, 1, dtype=F64)) == F64
    assert tfl._compute_dtype(torch.zeros(2, 1)) == torch.float32
    with pytest.raises(ValueError, match="float32 or float64"):
        tfl._compute_dtype(torch.zeros(2, 1, dtype=torch.float16))


# --- a numpy emulation of the kernels' order of work --------------------------

# mma.sync m16n8k8 f64, as the kernels' dmma() names its fragments: lane
# 4g + t holds A (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4), B (t, g),
# (t + 4, g), and C (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
def _a_map(lane):
    g, t = divmod(lane, 4)
    return [(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)]


def _b_map(lane):
    g, t = divmod(lane, 4)
    return [(t, g), (t + 4, g)]


def _c_map(lane):
    g, t = divmod(lane, 4)
    return [(g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t), (g + 8, 2 * t + 1)]


# C fragment to A fragment (the gene part's chain): a lane's C elements
# (c0, c1, c2, c3) as its A elements (c0, c2, c1, c3), C's column 2t as A's
# k-column t and 2t + 1 as t + 4, so the next B's row t is the old column
# 2t and row t + 4 the old 2t + 1.
C_TO_A = (0, 2, 1, 3)
K_OF_C_COLUMN = [c // 2 + 4 * (c % 2) for c in range(8)]


def _mma(a_frags, b_frags, c_frags):
    """One warp's m16n8k8: D = A B + C from the 32 lanes' fragments, each
    sum over k in A's column order; returns the lanes' D fragments."""
    A, B, C = np.zeros((16, 8)), np.zeros((8, 8)), np.zeros((16, 8))
    for lane in range(32):
        for (r, c), v in zip(_a_map(lane), a_frags[lane]):
            A[r, c] = v
        for (r, c), v in zip(_b_map(lane), b_frags[lane]):
            B[r, c] = v
        for (r, c), v in zip(_c_map(lane), c_frags[lane]):
            C[r, c] = v
    D = C.copy()
    for k in range(8):
        D += A[:, k:k + 1] * B[k:k + 1, :]
    return [[D[r, c] for r, c in _c_map(lane)] for lane in range(32)]


def _fwd_genes(ks):
    """The 8 genes (of a 32-gene stage) of the forward's k-step ks, in A's
    column order: column t is gene 8t + 2ks, column t + 4 gene 8t + 2ks + 1,
    so that lane t's 8 counts of a row in a stage are consecutive."""
    return [8 * (k % 4) + 2 * ks + k // 4 for k in range(8)]


def _tiles(M, n_tiles):
    """M's columns zero-padded to n_tiles tiles of 8."""
    out = np.zeros((M.shape[0], 8 * n_tiles))
    out[:, :M.shape[1]] = M
    return out


def _emulate_forward(Y, psi, W, log_mu, muL, p):
    """fwd_f64_kernel's sums: each column group (f_count tiles of [Y W | Y
    log mu^T], padded to tiles, then Z's) over stages of 32 genes, each of 4
    MMA k-steps of 8 genes in A's column order (_fwd_genes), Y's products
    with Y as A and Z's with rfe; the first group also A1, each lane's sum
    over its 8 genes a stage (lane t: 8t .. 8t + 7, two a k-step), its four
    lanes' sums then added as the butterfly does ((a0 + a1) + (a2 + a3))."""
    (N, G), Kf, SC = Y.shape, psi.shape[1], muL.shape[1]
    n_a2 = 0 if log_mu is None else log_mu.shape[0]
    yt, tiles = p["f_yt"], p["f_tiles"]
    B = np.concatenate([_tiles(np.concatenate([W, log_mu.T if n_a2 else np.zeros((G, 0))], 1),
                               yt), _tiles(muL, tiles - yt)], 1)
    out, lane_a1 = np.zeros((N, 8 * tiles)), np.zeros((4, N))
    for q, group in enumerate(_groups(tiles, p["f_groups"], p["f_count"])):
        cols = [8 * tile + c for tile in group for c in range(8)]
        ycols = [c for c in cols if c < 8 * yt]
        for g0 in range(0, G, 32):
            for ks in range(4):
                for gl in _fwd_genes(ks):
                    g = g0 + gl
                    if g >= G:
                        continue
                    lr = np.zeros(N)
                    for k in range(Kf):
                        lr += psi[:, k] * W[g, k]
                    if q == 0:
                        lane_a1[gl // 8] += Y[:, g] * lr
                    rf = np.exp(lr)
                    for c in cols:
                        out[:, c] += (Y[:, g] if c in ycols else rf) * B[g, c]
    A1 = (lane_a1[0] + lane_a1[1]) + (lane_a1[2] + lane_a1[3])
    return (A1, (out[:, Kf:Kf + n_a2] if n_a2 else None), out[:, 8 * yt:8 * yt + SC],
            out[:, :Kf])


def _emulate_dpsi(psi, W, muL, dA1, dZ, YW, p):
    """dpsi_f64_kernel's sums: dZ's groups one after another (d_nz tiles of
    8 columns each), each over the genes in k-steps of 8: drfe over the
    group's tiles in two chains (tile z to chain z mod 2, each over its
    tiles' columns in order; one chain where d_nz is 1), the second added
    to the first, log_rfe over [psi, X]'s
    columns in order (Kf FMAs, or MMAs tile by tile), t = exp(log_rfe) drfe,
    and the k-step's t W added in the chained A's column order (genes 0, 2,
    4, 6, 1, 3, 5, 7 of the k-step: K_OF_C_COLUMN); dA1 YW added last."""
    (N, Kf), G, SC = psi.shape, W.shape[0], muL.shape[1]
    nz = p["d_nz"]
    order = sorted(range(8), key=lambda c: K_OF_C_COLUMN[c])
    acc = np.zeros((N, Kf))
    chains = 2 if nz >= 2 else 1
    for q in range(p["d_groups"]):
        tiles = [range(8 * (q * nz + z), 8 * (q * nz + z + 1)) for z in range(nz)]
        for g0 in range(0, G, 8):
            for g in (g0 + c for c in order if g0 + c < G):
                lr = np.zeros(N)
                for k in range(Kf):
                    lr += psi[:, k] * W[g, k]
                dc = np.zeros((chains, N))
                for z, cols in enumerate(tiles):
                    for j in (j for j in cols if j < SC):
                        dc[z % chains] += dZ[:, j] * muL[g, j]
                d = dc[0]
                for c in range(1, chains):
                    d = d + dc[c]
                acc += (np.exp(lr) * d)[:, None] * W[g][None, :]
    return acc + dA1[:, None] * YW


def _pack_dpsi(W, muL, p):
    """dpsi_f64_pack_kernel's table as (k-steps, tiles, lanes, 2): for each
    k-step of 8 genes, every group's muL^T tiles (lane (g, t): gene g at
    columns 8 tile + t, + 4), dpsi's W tiles in C-to-A order (lane (g, t):
    genes 2t, 2t + 1 at column 8 kc + g) and, past d_nk 1, log_rfe's W^T
    tiles (lane (g, t): gene g at columns 8 kc + t, + 4; d_nk of them);
    zero past G and every width."""
    (G, Kf), SC = W.shape, muL.shape[1]
    nz_all, nk = p["d_groups"] * p["d_nz"], p["d_nk"]
    tiles = nz_all + nk + (nk if nk > 1 else 0)
    steps = -(-G // (8 * p["d_steps"])) * p["d_steps"]
    at = lambda M, r, c: M[r, c] if r < M.shape[0] and c < M.shape[1] else 0.0  # noqa: E731
    table = np.zeros((steps, tiles, 32, 2))
    for ks, r, lane in np.ndindex(steps, tiles, 32):
        g, t = divmod(lane, 4)
        if r < nz_all:
            pair = (at(muL, 8 * ks + g, 8 * r + t), at(muL, 8 * ks + g, 8 * r + t + 4))
        elif r < nz_all + nk:
            k = 8 * (r - nz_all) + g
            pair = (at(W, 8 * ks + 2 * t, k), at(W, 8 * ks + 2 * t + 1, k))
        else:
            k = 8 * (r - nz_all - nk) + t
            pair = (at(W, 8 * ks + g, k), at(W, 8 * ks + g, k + 4))
        table[ks, r, lane] = pair
    return table


def _emulate_gene(Y, psi, W, muL, dA1, dA2, dZ, p):
    """gene_f64_kernel's sums: for each chunk of rows cells and each pass
    (g_count tiles of [dlog mu | d(muL)], padded to tiles), the cells in
    n-tiles of 8: drfe over the pass's d(muL) tiles (j in order), d = rfe
    drfe (+ Y dA1 in the first pass), then the pass's tiles and dW's tiles
    summed over the n-tile's cells in the chained A's column order (cells
    0, 2, 4, 6, 1, 3, 5, 7: K_OF_C_COLUMN), dlog mu's with Y as A, d(muL)'s
    with rfe, dW's with d; each pass's dW sums added to the chunk's after
    it; the chunks' partial sums [dW^T; d(muL)^T; dlog mu] then added in
    chunk order (reduce_chunks_f64_kernel)."""
    (N, G), Kf, SC = Y.shape, psi.shape[1], muL.shape[1]
    n_a2 = 0 if dA2 is None else dA2.shape[1]
    st, tiles = p["g_st"], p["g_tiles"]
    Bn = np.concatenate([_tiles(dA2 if n_a2 else np.zeros((N, 0)), st),
                         _tiles(dZ, tiles - st)], 1)
    mu = _tiles(muL, tiles - st)
    order = sorted(range(8), key=lambda c: K_OF_C_COLUMN[c])
    parts = []
    for ch in range(p["n_chunks"]):
        part = np.zeros((Kf + SC + n_a2, G))
        cells = range(ch * p["rows"], min(N, (ch + 1) * p["rows"]))
        for q, group in enumerate(_groups(tiles, p["g_passes"], p["g_count"])):
            cols = [8 * tile + c for tile in group for c in range(8)]
            jcols = [c - 8 * st for c in cols if c >= 8 * st]
            acc, dw = np.zeros((8 * tiles, G)), np.zeros((Kf, G))
            for n0 in range(cells.start, cells.stop, 8):
                tile_cells = [n0 + c for c in order if n0 + c < cells.stop]
                for n in tile_cells:
                    dr = np.zeros(G)
                    for j in jcols:
                        dr += mu[:, j] * (dZ[n, j] if j < SC else 0.0)
                    lr = np.zeros(G)
                    for k in range(Kf):
                        lr += W[:, k] * psi[n, k]
                    rf = np.exp(lr)
                    d = rf * dr
                    if q == 0:
                        d = d + Y[n] * dA1[n]
                    for c in cols:
                        acc[c] += (Y[n] if c < 8 * st else rf) * Bn[n, c]
                    dw += d[None, :] * psi[n][:, None]
            for c in cols:
                if c < 8 * st and c < n_a2:
                    part[Kf + SC + c] = acc[c]
                elif c >= 8 * st and c - 8 * st < SC:
                    part[Kf + c - 8 * st] = acc[c]
            part[:Kf] += dw
        parts.append(part)
    total = np.zeros_like(parts[0])
    for part in parts:
        total += part
    return total[:Kf].T, (total[Kf + SC:] if n_a2 else None), total[Kf:Kf + SC].T


def _staged(a, b):
    """a (M, K) b (K, N) summed over stages of 16 of K in order (the split
    kernels' tiled products)."""
    out = np.zeros((a.shape[0], b.shape[1]))
    for k in range(0, a.shape[1], 16):
        out = out + a[:, k:k + 16] @ b[k:k + 16]
    return out


def _ranged(t, w, n, genes):
    """dpsi_product_f64_kernel and dpsi_sum_f64_kernel: t w over n ranges of
    ``genes`` genes (each a staged product), the ranges' sums added in
    order."""
    out = 0.0
    for z in range(n):
        g = slice(z * genes, min(w.shape[0], (z + 1) * genes))
        out = out + _staged(t[:, g], w[g])
    return out


def _row_blocks(N, p):
    return [slice(b0, min(N, b0 + p["rows"])) for b0 in range(0, N, p["rows"])]


def _emulate_forward_split(Y, psi, W, log_mu, muL, p):
    """The split forward's sums: for each row block of ``rows`` cells,
    log_rfe = psi W^T over stages of 16 of [psi, X]'s columns, A1 the row's
    sums of Y log_rfe over each 32 genes added in order
    (dlog_rfe_f64_kernel<YT, 2> and reduce_chunks_f64_kernel), Z = rfe muL
    over the plan's zsplit gene ranges (:func:`_ranged`); Y W and A2 by
    fwd_f64_kernel's groups of Y tiles (:func:`_emulate_forward`)."""
    N, G = Y.shape
    A1, Z = np.zeros(N), np.zeros((N, muL.shape[1]))
    for rows in _row_blocks(N, p):
        lr = _staged(psi[rows], W.T)
        yl = Y[rows] * lr
        for g0 in range(0, G, 32):
            A1[rows] = A1[rows] + yl[:, g0:g0 + 32].sum(1)
        Z[rows] = _ranged(np.exp(lr), muL, p["zsplit"], p["zgenes"])
    _, A2, _, YW = _emulate_forward(Y, psi, W, log_mu, muL[:, :0], p)  # no Z tiles
    return A1, A2, Z, YW


def _emulate_dpsi_split(psi, W, muL, dA1, dZ, YW, p, Y=None):
    """The split dpsi's sums: for each row block, t = rfe drfe (log_rfe and
    drfe = dZ muL^T over stages of 16), dpsi = t W over the plan's dsplit
    gene ranges (:func:`_ranged`), then dA1 YW added last; with Y (the
    joint backward's one call) dlog_rfe = Y dA1 + rfe drfe in t's place and
    no dA1 YW."""
    dpsi = np.zeros(psi.shape)
    for rows in _row_blocks(psi.shape[0], p):
        t = np.exp(_staged(psi[rows], W.T)) * _staged(dZ[rows], muL.T)
        if Y is not None:
            t = Y[rows] * dA1[rows, None] + t
        dpsi[rows] = _ranged(t, W, p["dsplit"], p["dgenes"])
        if Y is None:
            dpsi[rows] = dpsi[rows] + dA1[rows, None] * YW[rows]
    return dpsi


def _emulate_gene_split(Y, psi, W, muL, dA1, dA2, dZ, p):
    """The split gene part's sums (dlog_rfe_f64_kernel, gene_product_f64_kernel):
    for each row block of ``rows`` cells, log_rfe = psi W^T and drfe = dZ
    muL^T over stages of 16 of their K in order, rfe = exp(log_rfe) and
    dlog_rfe = Y dA1 + rfe drfe (one fma); then over each slice of
    ``gcells`` cells (the row block where one slice) dW^T = psi^T dlog_rfe,
    d(muL)^T = dZ^T rfe and dlog mu = dA2^T Y over stages of 16 cells in
    order, the slices' partial sums added in order, the row blocks' sums
    into the output in order (the first stores)."""
    (N, G), Kf, SC = Y.shape, psi.shape[1], muL.shape[1]
    staged = _staged
    out = None
    for b0 in range(0, N, p["rows"]):
        cells = slice(b0, min(N, b0 + p["rows"]))
        rfe = np.exp(staged(psi[cells], W.T))
        dlog = Y[cells] * dA1[cells, None] + rfe * staged(dZ[cells], muL.T)
        n = cells.stop - cells.start
        block = None
        for c0 in range(0, n, p["gcells"]):
            sl = slice(c0, min(n, c0 + p["gcells"]))
            part = [staged(psi[cells][sl].T, dlog[sl]), staged(dZ[cells][sl].T, rfe[sl])]
            if dA2 is not None:
                part.append(staged(dA2[cells][sl].T, Y[cells][sl]))
            block = part if block is None else [u + v for u, v in zip(block, part)]
        out = block if out is None else [u + v for u, v in zip(out, block)]
    return out[0].T, (out[2] if dA2 is not None else None), out[1].T


def test_mma_fragment_maps_reproduce_the_product():
    """The m16n8k8 f64 fragment maps the kernels use (A, B, C) give A B + C
    exactly as numpy's product does on integers, every (row, column) held by
    one lane once; and the C-to-A chain: a product's C fragments as the next
    product's A fragments (C_TO_A), with the next B's rows permuted to match
    (row t the old column 2t, row t + 4 the old 2t + 1), give C B2; the
    forward's k-steps take every gene of a stage once, each lane's 8 of a
    row consecutive."""
    rng = np.random.default_rng(0)
    A, B, C = (rng.integers(-9, 10, shape).astype(np.float64)
               for shape in ((16, 8), (8, 8), (16, 8)))
    for fmap, shape in ((_a_map, (16, 8)), (_b_map, (8, 8)), (_c_map, (16, 8))):
        held = sorted(rc for lane in range(32) for rc in fmap(lane))
        assert held == sorted(np.ndindex(*shape))
    frag = lambda M, fmap: [[M[r, c] for r, c in fmap(lane)] for lane in range(32)]
    D = _mma(frag(A, _a_map), frag(B, _b_map), frag(C, _c_map))
    np.testing.assert_array_equal(np.array(D), np.array(frag(A @ B + C, _c_map)))
    B2 = rng.integers(-9, 10, (8, 8)).astype(np.float64)
    chained_a = [[d[i] for i in C_TO_A] for d in D]
    permuted = B2[np.argsort(K_OF_C_COLUMN)]  # row k of the chain's B: old column of A's k
    D2 = _mma(chained_a, frag(permuted, _b_map), [[0.0] * 4] * 32)
    np.testing.assert_array_equal(np.array(D2), np.array(frag((A @ B + C) @ B2, _c_map)))
    genes = [[g for ks in range(4) for g in _fwd_genes(ks) if g // 8 == t] for t in range(4)]
    assert sorted(sum(genes, [])) == list(range(32))
    assert all(sorted(genes[t]) == list(range(8 * t, 8 * t + 8)) for t in range(4))


@pytest.mark.parametrize("Kf, SC", [(1, 10), (5, 80), (8, 3), (16, 20), (64, 2048)])
def test_dpsi_k_step_chain_reproduces_the_product(Kf, SC):
    """One warp's k-step of dpsi_f64_kernel on integers, its operands read
    as the kernel reads them from dpsi_f64_pack_kernel's table (_pack_dpsi)
    and from its fragments of psi and dZ: drfe = dZ muL^T by the group's
    MMAs in two chains (every group's columns in turn), log_rfe = psi W^T by Kf FMAs from
    dpsi's own W tile (entry 4k + t: d_nk 1) or by MMAs with W^T tiles,
    then t = R drfe (R standing in for rfe, whose exp leaves the integers)
    taken from the C fragment into the A fragment (C_TO_A) of dpsi += t W
    against the W tiles: each exactly numpy's product, at 16 cells and the
    k-step's 8 genes (up to Kf 64: past it dpsi is the split one)."""
    rng = np.random.default_rng(Kf + SC)
    p = tfl.f64_plan(16, 8, Kf, 0, SC)
    ints = lambda *shape: rng.integers(-4, 5, shape).astype(np.float64)  # noqa: E731
    psi, W, dZ, muL, R = ints(16, Kf), ints(8, Kf), ints(16, SC), ints(8, SC), ints(16, 8)
    table = _pack_dpsi(W, muL, p)[0]
    frag = lambda M, fmap: [[M[r, c] for r, c in fmap(lane)] for lane in range(32)]  # noqa: E731
    pad = lambda M, cols: np.pad(M, ((0, 0), (0, cols - M.shape[1])))  # noqa: E731
    nz_all, nk = p["d_groups"] * p["d_nz"], p["d_nk"]
    lr = nk if nk > 1 else 0
    assert nk == 1 or lr >= -(-Kf // 8)
    zero = [[0.0] * 4] * 32
    chains = [zero, zero]  # tile z to chain z mod 2, added last
    for z in range(nz_all):  # dZ's A fragments (n0, j), (n1, j), (n0, j + 4), (n1, j + 4)
        chains[z % 2] = _mma(frag(pad(dZ, 8 * nz_all)[:, 8 * z:8 * z + 8], _a_map), table[z],
                             chains[z % 2])
    dr = [[a + b for a, b in zip(*lanes)] for lanes in zip(*chains)]
    np.testing.assert_array_equal(np.array(dr), np.array(frag(dZ @ muL.T, _c_map)))
    if nk == 1:  # lane (g, t): psi's rows g, g + 8 and W's pair of entry 4k + t
        lr = [[sum(psi[r, k] * table[nz_all, 4 * k + lane % 4][c % 2] for k in range(Kf))
               for r, c in _c_map(lane)] for lane in range(32)]
    else:
        lrf = zero
        for kc in range(lr):
            lrf = _mma(frag(pad(psi, 8 * lr)[:, 8 * kc:8 * kc + 8], _a_map),
                       table[nz_all + nk + kc], lrf)
        lr = lrf
    np.testing.assert_array_equal(np.array(lr), np.array(frag(psi @ W.T, _c_map)))
    t = [[R[r, c] * d for (r, c), d in zip(_c_map(lane), dr[lane])] for lane in range(32)]
    chained_a = [[v[i] for i in C_TO_A] for v in t]
    want = (R * (dZ @ muL.T)) @ pad(W, 8 * nk)
    for kc in range(nk):
        got = _mma(chained_a, table[nz_all + kc], zero)
        np.testing.assert_array_equal(np.array(got), np.array(frag(want[:, 8 * kc:8 * kc + 8],
                                                                    _c_map)))


@pytest.mark.parametrize("shape", [(37, 41, 2, 1, 1), (70, 60, 10, 6, 8), (40, 30, 3, 64, 64),
                                   (2100, 20, 9, 2, 4), (40, 30, 10, 72, 66),
                                   (2100, 20, 33, 1, 66)])
def test_kernel_order_emulation_meets_the_tolerance(shape):
    """The emulated kernels (column groups, dpsi's term order, the gene
    part's passes and chunk partials; past the old bound the split
    forward's, dpsi's and gene part's row blocks, gene ranges and cell
    slices, :func:`_emulate_forward_split`, :func:`_emulate_dpsi_split`
    alone and in the one call, :func:`_emulate_gene_split`, at the last
    shape in 9 slices) against reference_likelihood_terms and
    reference_likelihood_vjp in float64, within ABS_RTOL of each element's
    absolute-term sum, with A2 on and off: the decomposition the kernels
    run is the contract's."""
    N, G, C, K, S = shape
    x = _inputs(N, G, C, K, S, seed=N + G)
    Y, psi, W, log_mu, muL = x
    cot = _cotangents(N, S, S * C, seed=N + G)
    scale = _scales(*x, *cot)
    for with_a2 in (True, False):
        lm, dA2 = (log_mu, cot[1]) if with_a2 else (None, None)
        p = tfl.f64_plan(N, G, K, S if with_a2 else 0, S * C)
        got = (_emulate_forward_split if p["split"] else _emulate_forward)(Y, psi, W, lm, muL, p)
        want = tfl.reference_likelihood_terms(*(None if a is None else _t(a)
                                                for a in (Y, psi, W, lm, muL)))
        for name, g, w in zip(("A1", "A2", "Z"), got, want):
            if w is not None:
                _assert_within(g, w.numpy(), scale[name], name)
        _assert_within(got[3], Y @ W, scale["YW"], "YW")
        p0 = tfl.f64_plan(N, G, K, 0, S * C)
        dpsi = (_emulate_dpsi_split if p0["split"] else _emulate_dpsi)(
            psi, W, muL, cot[0], cot[2], got[3], p0)
        gene = (_emulate_gene_split if p["split"] else _emulate_gene)(
            Y, psi, W, muL, cot[0], dA2, cot[2], p)
        want = tfl.reference_likelihood_vjp(*(None if a is None else _t(a) for a in
                                              (Y, psi, W, muL, cot[0], dA2, cot[2])))
        for name, g, w in zip(("dpsi", "dW", "dlog_mu", "dmuL"), (dpsi, *gene), want):
            if w is not None:
                _assert_within(g, w.numpy(), scale[name], name)
        if p["split"]:  # kernel_backward's one call: dpsi from the gene part's dlog_rfe
            joint = _emulate_dpsi_split(psi, W, muL, cot[0], cot[2], None, p, Y=Y)
            _assert_within(joint, want[0].numpy(), scale["dpsi"], "dpsi (one call)")


def _past_inputs(N, G, Kf, n_a2, SC, seed):
    """Y, psi, W, log_mu (n_a2 x G, possibly empty), muL (G x SC) and the
    cotangents dA1, dA2, dZ at a plan's widths (:func:`_inputs`' recipe)."""
    rng = np.random.default_rng(seed)
    Y = rng.poisson(3.0, (N, G)).astype(np.float64)
    psi = rng.normal(0, 1, (N, Kf))
    W = rng.normal(0, 0.3 / np.sqrt(max(Kf, 1)), (G, Kf))
    log_mu = rng.normal(0, 0.5, (n_a2, G))
    muL = rng.lognormal(0, 0.5, (G, SC)) * rng.integers(1, 5, (G, SC))
    return (Y, psi, W, log_mu, muL), (rng.normal(size=N), rng.normal(size=(N, n_a2)),
                                      rng.normal(size=(N, SC)))


# PAST_PLAN_SHAPES small enough for the CPU (at most 1e6 cells x genes)
SMALL_PAST_PLAN_SHAPES = [s for s in PAST_PLAN_SHAPES if s[0] * s[1] <= 1_000_000]


@pytest.mark.parametrize("blocks", ["plan", "small"])
@pytest.mark.parametrize("shape", SMALL_PAST_PLAN_SHAPES)
def test_split_sum_order_meets_the_tolerance_against_jax(shape, blocks, jax_ops):
    """The split forward's, dpsi's (alone and from the gene part's dlog_rfe
    in the one call) and gene part's sums in the kernels' order (row
    blocks, the gene ranges' sums added in order, dA1 YW last, the slices'
    and row blocks' partial sums in order; :func:`_emulate_forward_split`,
    :func:`_emulate_dpsi_split`, :func:`_emulate_gene_split`) against the
    JAX package's plain float64 likelihood terms and jax.vjp of them (CPU,
    x64), within ABS_RTOL of each element's absolute-term sum, at
    f64_plan's row blocks and gene ranges and (``small``) at row blocks of
    64 cells, gene ranges of 32 genes and cell slices of 32, so that every
    order has several terms at a small shape."""
    jax, jnp, jfl = jax_ops
    N, G, Kf, n_a2, SC = shape
    x, cot = _past_inputs(N, G, Kf, n_a2, SC, seed=N + Kf + SC)
    Y, psi, W, log_mu, muL = x
    values, vjp = jax.vjp(lambda *a: jfl.reference_likelihood_terms(jnp.asarray(Y), *a),
                          *(jnp.asarray(a) for a in x[1:]))
    want_f = [np.asarray(v) for v in values]
    want_b = [np.asarray(v) for v in vjp(tuple(jnp.asarray(c) for c in cot))]
    scale = _scales(*x, *cot)
    p = tfl.f64_plan(N, G, Kf, n_a2, SC)
    p0 = tfl.f64_plan(N, G, Kf, 0, SC)
    if blocks == "small":
        small = dict(rows=64, dsplit=-(-G // 32), dgenes=32, zsplit=-(-G // 32), zgenes=32,
                     gslices=1, gcells=64)
        p, p0 = dict(p, **small), dict(p0, **small)
    assert p["split"]
    A1, A2, Z, YW = _emulate_forward_split(Y, psi, W, log_mu if n_a2 else None, muL, p)
    for name, got, want in (("A1", A1, want_f[0]), ("Z", Z, want_f[2]), ("YW", YW, Y @ W)):
        _assert_within(got, want, scale[name] if name != "YW" else Y @ np.abs(W), name)
    if n_a2:
        _assert_within(A2, want_f[1], scale["A2"], "A2")
    dA1, dA2, dZ = cot
    joint = _emulate_dpsi_split(psi, W, muL, dA1, dZ, None, p, Y=Y)
    _assert_within(joint, want_b[0], scale["dpsi"], "dpsi (one call)")
    if p0["split"]:
        alone = _emulate_dpsi_split(psi, W, muL, dA1, dZ, YW, p0)
        _assert_within(alone, want_b[0], scale["dpsi"], "dpsi alone")
    dW, dlog_mu, dmuL = _emulate_gene_split(Y, psi, W, muL, dA1, dA2 if n_a2 else None, dZ, p)
    _assert_within(dW, want_b[1], scale["dW"], "dW")
    _assert_within(dmuL, want_b[3], scale["dmuL"], "dmuL")
    if n_a2:
        _assert_within(dlog_mu, want_b[2], scale["dlog_mu"], "dlog_mu")


# --- the sweep's reckoning --------------------------------------------------

def test_sweep_bytes_count_float64():
    """In float64 _sweep_bytes counts 8 bytes a value and, with the exact
    backward on the card, the float64 gene part's workspace and dpsi's
    packed table (f64_plan's gene_workspace and dpsi_workspace, 8 bytes a
    value) once, at every width, where the float32 family's workspace
    stood, beside the forward's packed table (fwd_workspace) in either
    backward; the CPU counts no workspace, and every term but Y's bytes
    doubles from float32."""
    N, G, C, K = 100_000, 5_000, 10, 1
    block = tmm._CHUNK_ELEMENTS
    for P, S in ((0, 1), (4, 8)):
        plan = tfl.f64_plan(N, G, K + P, 0, S * C)
        ws = 8 * (plan["gene_workspace"] + plan["dpsi_workspace"])

        def sweep(n_lanes, itemsize=8, device_type="cuda", y_itemsize=1, z_cheb=False):
            return trestarts._sweep_bytes(N, G, C, K, S, n_lanes, itemsize, device_type,
                                          y_itemsize, P, z_cheb=z_cheb)

        fwd_ws = 8 * tfl.f64_plan(N, G, K + P, 0, S * C)["fwd_workspace"]
        with_table = {z: sweep(3, z_cheb=z) for z in (False, True)}
        for n_lanes in (1, 3, 10):
            assert sweep(n_lanes) - sweep(n_lanes, z_cheb=True) == ws - 8 * block
        real_plan = tfl.f64_plan
        try:  # every forward's table counts, z_cheb's too
            tfl.f64_plan = lambda *a: dict(real_plan(*a), fwd_workspace=0)
            for z_cheb in (False, True):
                assert with_table[z_cheb] == fwd_ws + sweep(3, z_cheb=z_cheb)
        finally:
            tfl.f64_plan = real_plan
            assert sweep(n_lanes, y_itemsize=8) - sweep(n_lanes, y_itemsize=8, z_cheb=True) == ws
            assert sweep(n_lanes, device_type="cpu") - N * G == 2 * (
                sweep(n_lanes, 4, "cpu") - N * G)
            assert sweep(n_lanes, y_itemsize=8) - sweep(n_lanes) == 7 * N * G
        assert trestarts._auto_restart_batching(N, G, C, K, S, 3, 8, "cuda", 1, P) == "vmap"


# --- the plain versions against the JAX package ------------------------------

@pytest.fixture(scope="module")
def jax_ops():
    """(jax, jax.numpy, the JAX package's fused-likelihood module), x64 on."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    jfl = pytest.importorskip("clonealign_tpu.ops.fused_likelihood")
    return jax, jax.numpy, jfl


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("shape", [(37, 41, 2, 1, 1), (70, 60, 10, 6, 8)])
def test_plain_versions_match_jax_float64(shape, storage, jax_ops):
    """The float64 plain versions (the float64 kernels' check on the card
    and the CPU path) with Y in ``storage``, and the autograd function's
    CPU gradients, against the JAX package's exact float64 likelihood
    terms and jax.vjp of them, Y in the same type: within ABS_RTOL of each
    element's absolute-term sum."""
    jax, jnp, jfl = jax_ops
    N, G, C, K, S = shape
    x = _inputs(N, G, C, K, S, seed=N + G)
    cot = _cotangents(N, S, S * C, seed=N + G)
    scale = _scales(*x, *cot)
    jY = jnp.asarray(x[0]).astype(jnp.dtype(str(storage).removeprefix("torch.")))
    args = [jnp.asarray(a, jnp.float64) for a in x[1:]]
    values, vjp = jax.vjp(lambda *a: jfl.reference_likelihood_terms(jY, *a), *args)
    assert all(v.dtype == jnp.float64 for v in values)
    want = vjp(tuple(jnp.asarray(c, jnp.float64) for c in cot))
    Y = _t(x[0]).to(storage)
    psi, W, log_mu, muL = map(_t, x[1:])
    for name, o, v in zip(("A1", "A2", "Z"), tfl.reference_likelihood_terms(Y, psi, W, log_mu, muL),
                          values):
        assert o.dtype == F64
        _assert_within(o.numpy(), np.asarray(v), scale[name], name)
    dA1, dA2, dZ = map(_t, cot)
    explicit = tfl.reference_likelihood_vjp(Y, psi, W, muL, dA1, dA2, dZ)
    leaves = [t.clone().requires_grad_(True) for t in (psi, W, log_mu, muL)]
    auto = torch.autograd.grad(tfl.fused_likelihood_terms(Y, *leaves), leaves,
                               grad_outputs=(dA1, dA2, dZ))
    for name, w, e, a in zip(("dpsi", "dW", "dlog_mu", "dmuL"), want, explicit, auto):
        assert e.dtype == a.dtype == F64
        _assert_within(e.numpy(), np.asarray(w), scale[name], name)
        _assert_within(a.numpy(), np.asarray(w), scale[name], name)


# --- float64 fits against the JAX package -------------------------------------

def test_run_clonealign_vmap_float64_matches_jax(monkeypatch):
    """run_clonealign(restart_batching="vmap") in float64 on the CPU against
    the JAX package's vmapped sweep: each lane replays the JAX lane's draws
    (its key split from PRNGKey(seed) into init and loop keys, the shared
    PCA from lane 0's), the PCA scores' arbitrary sign aligned to the JAX
    package's; the same iterations, ELBOs, best lane and labels (the bars of
    tests/test_torch_restarts.py's JAX test: rtol 1e-6)."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    jnp = jax.numpy
    ca = pytest.importorskip("clonealign_tpu")
    from clonealign_tpu.models import multinomial as jmm
    from test_torch_stream import JaxStreamKeys

    class JaxLaneKeys(JaxStreamKeys):
        def __init__(self, key):  # JaxStreamKeys' draws from a lane's key
            k_init, k_fit = jax.random.split(key)
            self.k_pca, self.k_jitter = jax.random.split(k_init)
            super(JaxStreamKeys, self).__init__(k_fit)

    port_pca = tmm.randomized_pca

    def aligned_pca(X, k, noise, **kwargs):
        got = port_pca(X, k, noise, **kwargs)
        want = torch.tensor(np.asarray(jmm.randomized_pca(jnp.asarray(X.numpy()), k,
                                                          noise.k_pca, **kwargs)))
        sign = torch.sign(torch.sum(got * want, dim=0))
        np.testing.assert_allclose((got * sign).numpy(), want.numpy(), rtol=1e-8, atol=1e-10)
        return got * sign

    seed, shrinks, repeats = 4, (0, 5), 2
    keys = jax.random.split(jax.random.PRNGKey(seed), len(shrinks) * repeats)
    monkeypatch.setattr(tmm, "randomized_pca", aligned_pca)
    monkeypatch.setattr(trestarts, "Noise", lambda s, device: JaxLaneKeys(keys[s - seed]))
    sim = simulate_multinomial(N=60, G=40, C=3, seed=6, mean_total=400)
    kw = dict(initial_shrinks=shrinks, n_repeats=repeats, max_iter=60, rel_tol=0.02,
              restart_batching="vmap", seed=seed, dtype="float64", print_elbos=False,
              verbose=False)
    want = ca.run_clonealign(sim.Y, sim.L, **kw)
    got = ct.run_clonealign(sim.Y, sim.L, device="cpu", **kw)
    np.testing.assert_allclose(got.multirun_info["elbos"], want.multirun_info["elbos"], rtol=1e-6)
    assert got.multirun_info["best_run"] == want.multirun_info["best_run"]
    assert got.multirun_info["clone_prevalences_at_different_shrinks"] == \
        want.multirun_info["clone_prevalences_at_different_shrinks"]
    assert got.convergence_info.n_iters == want.convergence_info.n_iters
    np.testing.assert_allclose(got.convergence_info.elbo, want.convergence_info.elbo, rtol=1e-6)
    assert got.clone == want.clone


# --- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")


def _on_card(shape, storage, seed):
    N, G, C, K, S = shape
    x = _inputs(N, G, C, K, S, seed)
    cot = _cotangents(N, S, S * C, seed)
    Y = _t(x[0], device="cuda").to(storage)
    return x, cot, Y, [_t(a, device="cuda") for a in x[1:]], [_t(a, device="cuda") for a in cot]


@pytest.mark.cuda
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("shape", CUDA_SHAPES)
def test_cuda_f64_kernels_match_plain(cuda, shape, storage):
    """The float64 forward, dpsi and gene part against the plain float64
    versions on the card, Y in ``storage``, A2 on and off: within ABS_RTOL
    of each element's absolute-term sum, every launch a float64 one (past
    the old bound the backward kernel_backward's one call, and dpsi alone,
    the split one's t-only form, held to the plain VJP's too)."""
    x, cot, Y, (psi, W, log_mu, muL), (dA1, dA2, dZ) = _on_card(shape, storage, seed=sum(shape))
    scale = _scales(*x, *cot)
    N, G, C, K, S = shape
    for with_a2 in (True, False):
        lm, d2 = (log_mu, dA2) if with_a2 else (None, None)
        past = tfl.split_route(K, S if with_a2 else 0, S * C)
        tfl.reset_launch_counts()
        got = tfl.kernel_forward(Y, psi, W, lm, muL)
        want = tfl.reference_likelihood_terms(Y, psi, W, lm, muL)
        for name, g, w in zip(("A1", "A2", "Z"), got, want):
            if w is not None:
                assert g.dtype == F64
                _assert_within(g.cpu(), w.cpu(), scale[name], name)
        _assert_within(got[3].cpu(), x[0] @ x[2], scale["YW"], "YW")
        back = tfl.kernel_backward(Y, psi, W, muL, dA1, d2, dZ, got[3])
        want = tfl.reference_likelihood_vjp(Y, psi, W, muL, dA1, d2, dZ)
        for name, g, w in zip(("dpsi", "dW", "dlog_mu", "dmuL"), back, want):
            if w is not None:
                _assert_within(g.cpu(), w.cpu(), scale[name], name)
        assert (tfl.fwd_f64_launches, tfl.dpsi_f64_launches, tfl.gene_f64_launches,
                tfl.split_f64_launches) == ((1, 0, 0, 1) if past else (1, int(K > 0), 1, 0))
        assert (tfl.fwd_launches, tfl.dpsi_launches, tfl.gene_launches, tfl.fwd_wide_launches,
                tfl.dpsi_wide_launches, tfl.gene_wide_launches, tfl.split_launches) == (0,) * 7
        alone = tfl.kernel_dpsi(psi, W, muL, dA1, dZ, got[3])
        _assert_within(alone.cpu(), want[0].cpu(), scale["dpsi"], "dpsi alone")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2100, 130, 9, 1, 4), (1000, 515, 12, 6, 8),
                                   (300, 100, 32, 64, 64), (130, 77, 2048, 1, 1),
                                   (90, 37, 5, 9, 2), (2100, 200, 66, 1, 33),
                                   (45_000, 100, 10, 72, 66)])
def test_cuda_f64_kernels_are_deterministic(cuda, shape):
    """Each float64 kernel is bit-identical across two launches (no
    atomics; the chunks' partial sums are added in a fixed order); past
    the old bound the split forward, dpsi alone, the gene part and
    kernel_backward's one call too, their slices' partial sums, gene
    ranges' sums and row blocks added in order (one row block in slices at
    2,100 x 200, two row blocks at 45,000 x 100, A2 on: every width past
    the bound)."""
    N, G, C, K, S = shape
    if K > 64 or S > 64 or S * C > 2048:
        p = tfl.f64_plan(N, G, K, S, S * C)
        assert p["split"] and (p["n_chunks"], p["gslices"] > 1) == (
            (2, False) if N == 45_000 else (1, True))
    _, _, Y, (psi, W, log_mu, muL), (dA1, dA2, dZ) = _on_card(shape, torch.int8, seed=3)
    fwd = [tfl.kernel_forward(Y, psi, W, log_mu, muL) for _ in range(2)]
    for a, b in zip(*fwd):
        assert torch.equal(a, b)
    YW = fwd[0][3]
    dpsi = [tfl.kernel_dpsi(psi, W, muL, dA1, dZ, YW) for _ in range(2)]
    assert torch.equal(*dpsi)
    gene = [tfl.kernel_gene(Y, psi, W, muL, dA1, dA2, dZ) for _ in range(2)]
    for a, b in zip(*gene):
        assert torch.equal(a, b)
    back = [tfl.kernel_backward(Y, psi, W, muL, dA1, dA2, dZ, YW) for _ in range(2)]
    for a, b in zip(*back):
        assert a is None or torch.equal(a, b)


class _NumpyNoise:
    """A fit's standard normals from one numpy generator, in call order, in
    the caller's dtype on its device."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def normal(self, what, shape, dtype, device):
        del what
        return torch.from_numpy(self.rng.standard_normal(tuple(shape))).to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("y_storage", ["auto", "float32"])
def test_cuda_clonealign_float64_equals_the_cpu(cuda, y_storage, monkeypatch):
    """A float64 clonealign on the card (the float64 kernels, Y as int8 or
    float64) against the CPU port's in float64 from the same numpy draws:
    the same iterations, the ELBO trace within 1e-9 relative, the same
    labels, and only float64 kernel launches. The PCA scores' sign is
    arbitrary, and the card's SVD and the CPU's return opposite ones here:
    both fits take each score column with its largest entry positive, so
    that they start from the same psi."""
    port_pca = tmm.pca_init_scores

    def signed_pca(*args, **kwargs):
        pcs = port_pca(*args, **kwargs)
        cols = torch.arange(pcs.shape[1], device=pcs.device)
        return pcs * torch.sign(pcs[pcs.abs().argmax(0), cols])

    monkeypatch.setattr(tmm, "pca_init_scores", signed_pca)
    sim = simulate_multinomial(N=300, G=120, C=3, seed=2, mean_total=600)
    kw = dict(max_iter=40, rel_tol=0.0, dtype="float64", verbose=False, y_storage=y_storage)
    tfl.reset_launch_counts()
    card = ct.clonealign(sim.Y, sim.L, device="cuda", noise=_NumpyNoise(5), **kw)
    launches = (tfl.fwd_f64_launches, tfl.dpsi_f64_launches, tfl.gene_f64_launches)
    cpu = ct.clonealign(sim.Y, sim.L, device="cpu", noise=_NumpyNoise(5), **kw)
    n = card.convergence_info.n_iters
    assert n == cpu.convergence_info.n_iters == 40
    assert launches == (2 + 2 * n + 20, n, n)
    assert (tfl.fwd_launches, tfl.dpsi_launches, tfl.gene_launches, tfl.fwd_wide_launches,
            tfl.dpsi_wide_launches, tfl.gene_wide_launches) == (0,) * 6
    np.testing.assert_allclose(card.convergence_info.elbo, cpu.convergence_info.elbo, rtol=1e-9)
    np.testing.assert_allclose(card.convergence_info.final_elbo, cpu.convergence_info.final_elbo,
                               rtol=1e-9)
    assert card.clone == cpu.clone


@pytest.mark.cuda
def test_cuda_mixed_dtypes_are_refused(cuda):
    """A float32 operand beside float64 ones, a float32 Y under float64, a
    float64 operand the kernels do not take (not contiguous) and a float16
    psi each raise; nothing falls back to the plain versions."""
    _, _, Y, (psi, W, log_mu, muL), (dA1, _, dZ) = _on_card((40, 30, 3, 2, 1), F64, seed=1)
    tfl.reset_launch_counts()
    with pytest.raises(ValueError, match="W_ext"):
        tfl.kernel_forward(Y, psi, W.float(), None, muL)
    with pytest.raises(ValueError, match="Y"):
        tfl.kernel_forward(Y.float(), psi, W, None, muL)
    with pytest.raises(ValueError, match="contiguous"):
        tfl.kernel_forward(Y, psi, W, None, muL.T.contiguous().T)
    with pytest.raises(ValueError, match="float32 or float64"):
        tfl.kernel_forward(Y, psi.half(), W, None, muL)
    with pytest.raises(ValueError, match="dZ"):
        tfl.kernel_dpsi(psi, W, muL, dA1, dZ.float(), psi)
    with pytest.raises(ValueError, match="dA1"):
        tfl.kernel_gene(Y, psi, W, muL, dA1.float(), None, dZ)
    assert (tfl.fwd_f64_launches, tfl.dpsi_f64_launches, tfl.gene_f64_launches) == (0, 0, 0)


def test_plan_argument_is_a_long_long_array():
    """The plan reaches the C entry points as F64_PLAN_KEYS' numbers, in
    order, as 64-bit integers."""
    p = tfl.f64_plan(1000, 515, 6, 8, 96)
    arg = tfl._plan_arg(p, tfl.F64_PLAN_KEYS)
    assert isinstance(arg, ctypes.Array) and arg._type_ is ctypes.c_longlong
    assert list(arg) == [p[k] for k in tfl.F64_PLAN_KEYS]
