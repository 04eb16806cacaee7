"""floxer_tpu_torch.scripts (K5-K8) against the research scripts' own
Pallas kernels in interpret mode.

The scripts (scripts/tpu_ablate_banded_kernel.py,
scripts/tpu_microbench_column_loop.py,
scripts/tpu_microbench_carry_scaling.py) probe for a TPU and time their
kernels when imported, so each test takes only their kernel builders and
`run` functions from the source, with the script's own constants and N cut
to 256 columns (two blocks of 128), and runs `pl.pallas_call` in interpret
mode. On the CPU each port entry runs its plain PyTorch version
(tests/test_torch_cuda.py holds the CUDA kernels against those on the
card). Every comparison is exact, on whole output arrays.
"""

import ast
import functools
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from floxer_tpu_torch import scripts
from floxer_tpu_torch.scripts import ablate_banded_kernel as k5
from floxer_tpu_torch.scripts import microbench_carry_scaling as k78
from floxer_tpu_torch.scripts import microbench_column_loop as k6

ROOT = Path(__file__).resolve().parent.parent
N = 256
CONSTANTS = {"S", "SUBLANES", "LANES", "BW", "TOP_BIT", "N"}


def script_tree(name: str) -> ast.Module:
    return ast.parse((ROOT / "scripts" / name).read_text())


@functools.lru_cache(maxsize=None)
def load_script(name: str, functions: tuple) -> dict:
    """The script's `functions` and constants (N replaced), executed in a
    namespace whose `pl.pallas_call` runs in interpret mode."""
    tree = script_tree(name)
    constants = [
        node for node in tree.body
        if isinstance(node, ast.Assign)
        and {getattr(t, "id", None) for t in node.targets} <= CONSTANTS
    ]
    defs = [
        node for node in tree.body
        if isinstance(node, ast.FunctionDef) and node.name in functions
    ]
    assert sorted(node.name for node in defs) == sorted(functions)
    interpret_pl = types.SimpleNamespace(
        **{k: getattr(pl, k) for k in dir(pl) if not k.startswith("__")}
    )
    interpret_pl.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    namespace = dict(
        jax=jax, jnp=jnp, pl=interpret_pl, pltpu=pltpu, np=np,
        functools=functools,
    )
    module = ast.Module(body=constants, type_ignores=[])
    exec(compile(module, name, "exec"), namespace)
    namespace["N"] = N
    exec(compile(ast.Module(body=defs, type_ignores=[]), name, "exec"), namespace)
    return namespace


def script_lists(name: str) -> list:
    """The literal lists the script loops over (and a VARIANTS list)."""
    lists = []
    for node in script_tree(name).body:
        literal = isinstance(getattr(node, "iter", None), (ast.List, ast.Tuple))
        if isinstance(node, ast.For) and literal:
            lists.append(list(ast.literal_eval(node.iter)))
        elif isinstance(node, ast.Assign) and any(
            getattr(t, "id", None) == "VARIANTS" for t in node.targets
        ):
            lists.append(list(ast.literal_eval(node.value)))
    return lists


def words(tensor: torch.Tensor) -> np.ndarray:
    """int32 tensor holding uint32 words -> uint32 array."""
    return tensor.numpy().view(np.uint32)


def texts_for(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 5, size=(32, N)).astype(np.int32)


def test_port_lists_are_the_scripts_lists():
    assert script_lists("tpu_microbench_column_loop.py") == [list(k6.VARIANTS)]
    assert script_lists("tpu_microbench_carry_scaling.py") == [
        list(k78.CONFIGS), list(k78.BCASTS)
    ]
    assert script_lists("tpu_ablate_banded_kernel.py") == [list(k5.VARIANTS)]


@pytest.mark.parametrize("variant", k6.VARIANTS)
def test_column_loop_matches_pallas(variant):
    run = load_script("tpu_microbench_column_loop.py", ("make_kernel", "run"))["run"]
    texts = texts_for(0)
    want = np.asarray(run(jnp.asarray(texts), variant))
    got = k6.column_loop(torch.from_numpy(texts), variant)
    assert got.shape == (32, 256) and got.dtype == torch.int32
    np.testing.assert_array_equal(words(got), want)


@pytest.mark.parametrize("config", k78.CONFIGS)
def test_carry_scaling_matches_pallas(config):
    run = load_script(
        "tpu_microbench_carry_scaling.py", ("make_kernel", "run")
    )["run"]
    texts = texts_for(2)
    want = np.asarray(run(jnp.asarray(texts), *config))
    got = k78.carry_scaling(torch.from_numpy(texts), *config)
    np.testing.assert_array_equal(words(got), want)


@pytest.mark.parametrize("n_bcast", k78.BCASTS)
def test_bcast_matches_pallas(n_bcast):
    run = load_script(
        "tpu_microbench_carry_scaling.py", ("make_bcast_kernel", "run_bcast")
    )["run_bcast"]
    texts = texts_for(0)
    jstar = k78.script_jstar(N)
    scal = jnp.asarray(jstar[:, None])
    want = np.asarray(run(jnp.asarray(texts), scal, n_bcast))
    got = k78.bcast(torch.from_numpy(texts), torch.from_numpy(jstar), n_bcast)
    np.testing.assert_array_equal(words(got), want)


def ablation_inputs(seed: int):
    """Seed 0: the script's own generator at N columns. Seed 1: jstar,
    topshift and tlen spread over (and past) the columns, mfrozen 0 or 1,
    so rows slide the whole run, freeze early or never score."""
    if seed == 0:
        return k5.script_inputs(N)
    rng = np.random.default_rng(seed)
    vp0 = rng.integers(0, 2**32, size=(32, 256), dtype=np.uint32)
    planes0 = rng.integers(0, 2**32, size=(32, 4, 256), dtype=np.uint32)
    texts = rng.integers(0, 5, size=(32, N)).astype(np.int32)
    stream = rng.integers(0, 5, size=(32, N)).astype(np.int32)
    scalars = np.stack(
        [
            rng.integers(0, N + 8, size=32),  # tlen
            rng.integers(0, N + 8, size=32),  # jstar
            rng.integers(0, N + 8, size=32),  # topshift
            rng.integers(0, 2, size=32),  # mfrozen
            rng.integers(0, 64, size=32),  # minit
            rng.integers(0, 64, size=32),  # binit
        ],
        axis=1,
    ).astype(np.int32)
    return vp0, planes0, texts, stream, scalars


def pallas_ablation(inputs, variant):
    run = load_script("tpu_ablate_banded_kernel.py", ("make_kernel", "run"))["run"]
    vp0, planes0, texts, stream, scalars = inputs
    dist, end = run(
        jnp.asarray(vp0), jnp.asarray(planes0), jnp.asarray(texts),
        jnp.asarray(stream),
        tuple(jnp.asarray(scalars[:, i : i + 1]) for i in range(6)), variant,
    )
    return np.asarray(dist)[:, 0], np.asarray(end)[:, 0]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("variant", k5.VARIANTS)
def test_ablation_matches_pallas(variant, seed):
    inputs = ablation_inputs(seed)
    want = pallas_ablation(inputs, variant)
    got = k5.ablate_banded(*k5.device_operands(inputs, torch.device("cpu")), variant)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])


@pytest.mark.parametrize("seed", [0, 1])
def test_ablation_full_equals_radix4(seed):
    """The radix-4 scan changes the carry scan's rounds, not its result:
    the script's kernel gives the same output for both, and so does the
    port; seed 1 also scores (some rows end past their start column)."""
    inputs = ablation_inputs(seed)
    full, r4 = (pallas_ablation(inputs, v) for v in ("full", "r4"))
    np.testing.assert_array_equal(full, r4)
    operands = k5.device_operands(inputs, torch.device("cpu"))
    got = k5.ablate_banded(*operands, "r4")
    np.testing.assert_array_equal(got[0].numpy(), full[0])
    if seed == 1:
        assert (full[1] > 0).any() and (full[1] < N).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_ablation_full_ends_where_k1_ends(seed):
    """K5's column is a copy of K1's (csrc/myers_banded.cu): on K1's
    operands, `full` ends every task at K1's end column. The card test of
    the same name holds the two CUDA kernels to it."""
    from floxer_tpu_torch.ops.cuda_myers_banded import (
        banded_operands,
        myers_banded,
    )

    rng = np.random.default_rng(seed)
    patterns, texts = [], []
    for _ in range(24):
        m = int(rng.integers(60, 300))
        n = int(rng.integers(m, m + 2 * (m // 10) + 60))
        text = rng.integers(1, 5, size=n).astype(np.uint8)
        start = int(rng.integers(0, n - m + 1))
        pattern = text[start : start + m].copy()
        for pos in rng.integers(0, m, size=int(rng.integers(0, m // 12 + 2))):
            pattern[pos] = 1 + (pattern[pos] % 4)
        patterns.append(pattern)
        texts.append(text)
    padded = np.zeros((len(texts), max(map(len, texts))), dtype=np.uint8)
    for i, text in enumerate(texts):
        padded[i, : len(text)] = text
    lengths = np.asarray([len(t) for t in texts], dtype=np.int32)
    budgets = np.asarray([max(1, len(p) // 10) for p in patterns])
    operands, num_text = banded_operands(
        patterns, padded, lengths, budgets, 32, torch.device("cpu")
    )
    _, k1_end = myers_banded(*operands, 32, num_text)
    _, k5_end = k5.ablate_banded(*k5.from_banded_operands(*operands), "full")
    np.testing.assert_array_equal(k5_end.numpy(), k1_end.numpy())
    assert (k1_end.numpy() > 0).all()


FULL = np.uint32(0xFFFFFFFF)


def _shfl_up(x, d, fill=0):
    """__shfl_up_sync over axis 1 (lanes): lane l reads lane l - d; the
    lanes below d read `fill` (each caller's value for them)."""
    out = np.empty_like(x)
    out[:, d:] = x[:, :-d]
    out[:, :d] = fill
    return out


def _radix4_scan(G, P):
    """myers_banded_column.cuh's radix4_scan on [rows, 32] lanes: the
    inclusive scan of (G, P) in rounds of shuffles at d, 2d, 3d."""
    gp = G | (P.astype(np.uint32) << np.uint32(1))
    d = 1
    while d < 32:
        s1 = _shfl_up(gp, d)
        cg, cp = gp & 1, gp >> 1
        if 2 * d < 32:
            s2, s3 = _shfl_up(gp, 2 * d), _shfl_up(gp, 3 * d)
            q1 = cp & (s1 >> 1)
            q2 = q1 & (s2 >> 1)
            cg = cg | (cp & s1 & 1) | (q1 & s2 & 1) | (q2 & s3 & 1)
            cp = q2 & (s3 >> 1)
        else:
            cg = cg | (cp & s1 & 1)
            cp = cp & (s1 >> 1)
        gp = cg | (cp << np.uint32(1))
        d *= 4
    return gp & 1


def emulate_k5(inputs, variant: str):
    """K5 as its CUDA kernel schedules it (csrc/ablate_banded_kernel.cu on
    csrc/myers_banded_column.cuh's column_reg), in numpy: [rows, 32 lanes,
    R words] uint32 arrays, lane l holding the band words [lR, (l+1)R);
    per column the slide's head shuffle down with lane 31 taking the
    entering row, the words' generate and propagate bits as per-run masks,
    the lanes' carries by the ballot look-ahead (or, for r4, the radix-4
    scan with shuffles at d, 2d, 3d), the in-run carries from the same
    identity, the shift's top bits shuffled up with lane 0 taking the
    pessimistic bit; then the sliding and the frozen loops' score updates
    in lane 31. Returns (dist, end) int32 [rows]."""
    off = k5._sections_off(variant) - {"full"}
    vp0, planes0, texts, stream, scalars = inputs
    rows, band_words = vp0.shape
    R = band_words // 32
    one = np.uint32(1)
    lane = np.arange(32, dtype=np.uint32)[None, :]

    def runs(a):
        return np.ascontiguousarray(a, dtype=np.uint32).reshape(rows, 32, R)

    vp, p0, p1, p2, am = runs(vp0), *(runs(planes0[:, k]) for k in range(4))
    vn = np.zeros_like(vp)
    tlen, jstar, topshift, mfrozen, minit, binit = scalars.astype(np.int64).T
    s_bot, s_m, best = binit.copy(), minit.copy(), minit.copy()
    best_end = np.zeros(rows, dtype=np.int64)
    num_text = texts.shape[1]
    slide_end = np.minimum(jstar, num_text)
    for col in range(1, num_text + 1):
        sliding = col <= slide_end
        tch = texts[:, col - 1].astype(np.uint32)[:, None, None]
        pch = stream[:, col - 1].astype(np.uint32)
        if "nostream2" in off:
            pch = np.zeros_like(pch)
        if "noslide" not in off:
            head = ((vp[:, :, 0] & 1) | ((vn[:, :, 0] & 1) << one)
                    | ((p0[:, :, 0] & 1) << np.uint32(2))
                    | ((p1[:, :, 0] & 1) << np.uint32(3))
                    | ((p2[:, :, 0] & 1) << np.uint32(4))
                    | ((am[:, :, 0] & 1) << np.uint32(5)))
            nxt = np.empty_like(head)
            nxt[:, :31] = head[:, 1:]
            nxt[:, 31] = 1 | ((pch & 7) << np.uint32(2))
            slid = []
            for bit, x in enumerate((vp, vn, p0, p1, p2, am)):
                above = np.concatenate(
                    [x[:, :, 1:], ((nxt >> np.uint32(bit)) & 1)[:, :, None]],
                    axis=2,
                )
                shifted = (x >> one) | (above << np.uint32(31))
                slid.append(np.where(sliding[:, None, None], shifted, x))
            vp, vn, p0, p1, p2, am = slid
        if "noeq" in off:
            eq = p0 ^ p1 ^ p2 ^ am ^ tch
        else:
            x0, x1, x2 = (np.where(tch & np.uint32(b), np.uint32(0), FULL)
                          for b in (1, 2, 4))
            eq = ((p0 ^ x0) & (p1 ^ x1) & (p2 ^ x2)) | am
        a = eq & vp
        t = a + vp
        carries = np.zeros((rows, 32), dtype=np.uint32)
        if "noks" not in off:
            word = np.arange(R, dtype=np.uint32)[None, None, :]
            gen_run = ((t < a).astype(np.uint32) << word).sum(
                axis=2, dtype=np.uint32)
            prop_run = ((t == FULL).astype(np.uint32) << word).sum(
                axis=2, dtype=np.uint32)
            any_run = gen_run | prop_run
            G = (any_run + gen_run) >> np.uint32(R)
            P = prop_run == np.uint32((1 << R) - 1)
            if "r4" in off:
                carry_in = _shfl_up(_radix4_scan(G, P), 1)
            else:
                gm = ((G != 0).astype(np.uint64) << lane).sum(
                    axis=1, dtype=np.uint64)[:, None]
                pm = (P.astype(np.uint64) << lane).sum(
                    axis=1, dtype=np.uint64)[:, None]
                any_ = gm | pm
                carry_in = ((((any_ + gm) ^ any_ ^ gm) >> lane) & 1).astype(
                    np.uint32)
            carries = (any_run + gen_run + carry_in) ^ any_run ^ gen_run
        word = np.arange(R, dtype=np.uint32)[None, None, :]
        summ = t + ((carries[:, :, None] >> word) & 1)
        xh = (summ ^ vp) | eq
        ph = vn | ~(xh | vp)
        mh = vp & xh
        vn = eq | vn
        top = (ph[:, :, -1] >> np.uint32(31)) | (
            (mh[:, :, -1] >> np.uint32(31)) << one)
        if "nohshift" in off:
            ph_sh, mh_sh = ph, mh
        else:
            pessim = np.where(sliding, col >= topshift, mfrozen != 0)
            hcarry = _shfl_up(top, 1)
            hcarry[:, 0] = pessim
            below_ph = np.concatenate(
                [(hcarry & 1)[:, :, None], ph[:, :, :-1] >> np.uint32(31)],
                axis=2)
            below_mh = np.concatenate(
                [((hcarry >> one) & 1)[:, :, None],
                 mh[:, :, :-1] >> np.uint32(31)], axis=2)
            ph_sh = (ph << one) | below_ph
            mh_sh = (mh << one) | below_mh
        vp = mh_sh | ~(vn | ph_sh)
        vn = ph_sh & vn
        d = (top[:, 31] & 1).astype(np.int64) - (top[:, 31] >> one)
        if "noslide" not in off:
            s_bot = s_bot + sliding
        if "noscore" in off:
            best, best_end = best + 1, best_end + 1
            continue
        s_bot = s_bot + d
        # the frozen loop; then, after the sliding loop's last column j*,
        # row m at the band bottom
        s_m = np.where(sliding, s_m, s_m + d)
        reaches = sliding & (col == jstar)
        s_m = np.where(reaches, s_bot, s_m)
        improves = (reaches | ~sliding) & (col < tlen) & (s_m <= best)
        best = np.where(improves, s_m, best)
        best_end = np.where(improves, col, best_end)
    acc = (vp ^ vn ^ p0 ^ p1 ^ p2 ^ am)[:, 31, R - 1].astype(np.int64)
    dist = (s_bot + s_m + best + best_end + acc) & 0xFFFFFFFF
    return (dist.astype(np.uint32).view(np.int32),
            best_end.astype(np.int32))


def _bit_planes(bits: np.ndarray) -> np.ndarray:
    """[rows, words, 32] bits (bit b of word w at [:, w, b]) -> uint32
    [rows, words]."""
    weights = np.uint32(1) << np.arange(32, dtype=np.uint32)
    return (bits.astype(np.uint32) * weights).sum(axis=2, dtype=np.uint32)


def emulation_inputs(R: int, num_text: int = 64):
    """4 rows of a band of 32 R words as K1 starts one (Vp all ones, the
    char planes of a pattern of chars 1..4, a rare all-match bit), where
    the carries run across words and lanes: a row that slides to j*
    mid-text and scores, one that slides the whole text, one frozen from
    the start with tlen 3, and a seeded one."""
    rng = np.random.default_rng(R)
    band_words = 32 * R
    vp0 = np.full((4, band_words), 0xFFFFFFFF, dtype=np.uint32)
    chars = rng.integers(1, 5, size=(4, band_words, 32))
    all_match = rng.random((4, band_words, 32)) < 0.002
    planes0 = np.stack(
        [_bit_planes((chars >> b) & 1) for b in range(3)]
        + [_bit_planes(all_match)], axis=1,
    )
    texts = rng.integers(0, 5, size=(4, num_text)).astype(np.int32)
    stream = rng.integers(0, 5, size=(4, num_text)).astype(np.int32)
    scalars = np.array([
        [num_text + 5, num_text // 3, 5, 1, 30, 10],
        [num_text // 2, num_text + 4, num_text // 4, 0, 12, 40],
        [3, 0, 0, 1, 7, 2],
        rng.integers(0, num_text + 8, size=6),
    ], dtype=np.int32)
    return vp0, planes0, texts, stream, scalars


@pytest.mark.parametrize("R", [1, 4])
@pytest.mark.parametrize("variant", k5.VARIANTS)
def test_k5_schedule_emulation_matches_plain(variant, R):
    """emulate_k5, the CUDA kernel's lane schedule, computes the plain
    version's function under every variant; r4 equals full."""
    inputs = emulation_inputs(R)
    dist, end = emulate_k5(inputs, variant)
    want = k5.ablate_banded_plain(
        *k5.device_operands(inputs, torch.device("cpu")), variant
    )
    np.testing.assert_array_equal(dist, want[0].numpy())
    np.testing.assert_array_equal(end, want[1].numpy())
    if variant == "r4":
        full = emulate_k5(inputs, "full")
        np.testing.assert_array_equal(dist, full[0])


def script_initial_values(name: str, function: str) -> list:
    """The start values of the carried arrays in the script's `function`
    (its `init` tuple of jnp.zeros / ones / full((S, BW), v) arrays)."""
    tree = script_tree(name)
    maker = next(node for node in tree.body
                 if isinstance(node, ast.FunctionDef) and node.name == function)
    init = next(node.value for node in ast.walk(maker)
                if isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "init")
    constant = {"zeros": 0, "ones": 1}
    return [constant[call.func.attr] if call.func.attr in constant
            else ast.literal_eval(call.args[1]) for call in init.elts]


def test_start_tables_hold_the_scripts_initial_values():
    """K6's table holds acc, v1, v2 and K8's x, y as the TPU scripts start
    them (K7's its carried arrays 1..10), each value in every word of its
    row, made once a device; the plain versions start from the same values
    (the Pallas parity tests hold them)."""
    assert script_initial_values(
        "tpu_microbench_column_loop.py", "make_kernel") == list(k6.STARTS)
    assert script_initial_values(
        "tpu_microbench_carry_scaling.py", "make_bcast_kernel"
    ) == list(k78.BCAST_STARTS)
    cpu = torch.device("cpu")
    for values in (k6.STARTS, k78.BCAST_STARTS, k78.CARRY_STARTS):
        table = scripts.start_table(values, cpu)
        assert table.dtype == torch.int32 and table.is_contiguous()
        np.testing.assert_array_equal(
            table.numpy(), np.repeat(np.array(values)[:, None], 256, axis=1))
    assert scripts.start_table(k6.STARTS, cpu) is scripts.start_table(
        k6.STARTS, cpu)


def column_chars(row: np.ndarray):
    """scripts/csrc/column_chars.cuh's ColumnChars in numpy: each column's
    char in order; the warp holds a block of 32 columns, lane l column
    32 b + l (0 past the row's end), loads the next block when it takes up
    the one before, and shuffles each column's char from its lane one
    column ahead."""
    num_text = len(row)

    def block(b):
        return [row[32 * b + lane] if 32 * b + lane < num_text else 0
                for lane in range(32)]

    now, ahead = block(0), block(1)
    following = now[0]
    for j in range(num_text):
        ch = following
        k = j + 1
        if k & 31 == 0:
            now, ahead = ahead, block((k >> 5) + 1)
        following = now[k & 31]
        yield ch


@pytest.mark.parametrize("num_text", [0, 1, 31, 32, 33, 65, 100])
def test_column_chars_schedule_gives_every_column_in_order(num_text):
    row = np.arange(1000, 1000 + num_text, dtype=np.int32)
    assert list(column_chars(row)) == list(row)


def lane_words(table_row: np.ndarray, rows: int) -> np.ndarray:
    """A start table's row as [rows, 32 lanes, 8 words]: lane l holds the
    band words [8l, 8l + 8)."""
    words = np.ascontiguousarray(table_row).view(np.uint32).reshape(1, 32, 8)
    return np.repeat(words, rows, axis=0)


def kernel_chars(texts: np.ndarray) -> np.ndarray:
    """uint32 [rows, num_text]: each row's chars as the kernels take them."""
    rows, num_text = texts.shape
    return np.array([list(column_chars(texts[r])) for r in range(rows)],
                    dtype=np.int64).reshape(rows, num_text).astype(np.uint32)


def emulate_k6(texts: np.ndarray, variant: str) -> np.ndarray:
    """K6 as its CUDA kernel schedules it (scripts/csrc/
    microbench_column_loop.cu), in numpy: acc, v1 and v2 as [rows, 32
    lanes, 8 words] from the start table; `elementwise` runs the 20 rounds
    on each of a lane's 8 words; `rolls` moves each word up inside the lane
    and the lane's top word up a lane (the shuffle), 0 into lane 0's word
    0. Returns acc as uint32 [rows, 256]."""
    rows, num_text = texts.shape
    table = scripts.start_table(k6.STARTS, torch.device("cpu")).numpy()
    acc, v1, v2 = (lane_words(table[a], rows) for a in range(3))
    chars = kernel_chars(texts)
    for j in range(num_text):
        ch = chars[:, j, None]
        if variant == "empty":
            acc += ch[:, :, None]
        elif variant == "elementwise":
            for i in range(8):
                x = v1[:, :, i].copy()
                for _ in range(20):
                    x = (x ^ v2[:, :, i]) + (x | v1[:, :, i])
                    v1[:, :, i] += np.uint32(1)
                acc[:, :, i] += x + ch
        else:
            x = v1.copy()
            for _ in range(12):
                below = _shfl_up(x[:, :, 7], 1)
                x[:, :, 1:] = x[:, :, :-1] | v2[:, :, 1:]
                x[:, :, 0] = below | v2[:, :, 0]
            acc += x + ch[:, :, None]
    return acc.reshape(rows, 256)


def emulate_k8(texts: np.ndarray, jstar: np.ndarray, n_bcast: int):
    """K8 as its CUDA kernel schedules it (scripts/csrc/
    microbench_carry_scaling.cu), in numpy: x and y as [rows, 32 lanes, 8
    words] from the start table; per column, each condition t compared
    once a row as j - js <= -t with js clamped to [-1, num_text + n_bcast],
    then applied to every word as a predicated xor. Returns (x as uint32
    [rows, 256], the count of true conditions [rows, num_text])."""
    rows, num_text = texts.shape
    table = scripts.start_table(
        k78.BCAST_STARTS, torch.device("cpu")).numpy()
    x, y = (lane_words(table[a], rows) for a in range(2))
    chars = kernel_chars(texts)
    js = np.clip(jstar.astype(np.int64), -1, num_text + n_bcast)
    counts = np.zeros((rows, num_text), dtype=np.int64)
    for j in range(num_text):
        d = j - js
        for t in range(n_bcast):
            true = (d <= -t)[:, None, None]
            counts[:, j] += true[:, 0, 0]
            x = np.where(true, x ^ y, x)
        x += chars[:, j, None, None]
        y += np.uint32(1)
    return x.reshape(rows, 256), counts


EMULATION_COLUMNS = (37, 128)


@pytest.mark.parametrize("num_text", EMULATION_COLUMNS)
@pytest.mark.parametrize("variant", k6.VARIANTS)
def test_k6_schedule_emulation_matches_plain(variant, num_text):
    """emulate_k6, the CUDA kernel's lane schedule, computes the plain
    version's function (37 columns: a short last block)."""
    texts = np.random.default_rng(num_text).integers(
        0, 5, size=(32, num_text)).astype(np.int32)
    want = k6.column_loop_plain(torch.from_numpy(texts), variant)
    np.testing.assert_array_equal(emulate_k6(texts, variant), words(want))


@pytest.mark.parametrize("num_text", EMULATION_COLUMNS)
@pytest.mark.parametrize("n_bcast", k78.BCASTS)
def test_k8_schedule_emulation_matches_plain(n_bcast, num_text):
    """emulate_k8 computes the plain version's function, for jstar past
    both ends of int32 and of the row too; each column's count of true
    conditions is min(max(jstar - j + 1, 0), n_bcast)."""
    rng = np.random.default_rng(100 + num_text)
    texts = rng.integers(0, 5, size=(32, num_text)).astype(np.int32)
    jstar = rng.integers(0, num_text, size=32).astype(np.int32)
    jstar[:6] = [-2**31, -5, 0, num_text - 1, num_text + 100, 2**31 - 1]
    got, counts = emulate_k8(texts, jstar, n_bcast)
    want = k78.bcast_plain(torch.from_numpy(texts), torch.from_numpy(jstar),
                           n_bcast)
    np.testing.assert_array_equal(got, words(want))
    j = np.arange(num_text)[None, :]
    np.testing.assert_array_equal(
        counts, np.clip(jstar.astype(np.int64)[:, None] - j + 1, 0, n_bcast))


def test_ptxas_log_reports_static_shared_memory():
    """A kernel whose ptxas line reports static shared memory gets its
    bytes as "shared"; one whose line reports none gets no such key."""
    from floxer_tpu_torch.ops import _build

    log = """ptxas info    : Compiling entry function '_Z1av' for 'sm_90a'
ptxas info    : Function properties for _Z1av
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 31 registers, used 0 barriers, 3072 bytes smem, 380 bytes cmem[0]
ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'
ptxas info    : Function properties for _Z1bv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers, 380 bytes cmem[0]
"""
    usage = _build.parse_ptxas_log(log)
    assert usage["_Z1av"]["shared"] == 3072 and usage["_Z1av"]["registers"] == 31
    assert "shared" not in usage["_Z1bv"] and usage["_Z1bv"]["registers"] == 40


def test_cuda_wrapper_refuses_other_band_widths():
    """The CUDA kernel is built at 128, 256 and 384 band words; another
    width is refused before the device is looked at, never sent to the
    plain version."""
    for band_words in (64, 512):
        operands = k5.device_operands(
            k5.script_inputs(64, band_words), torch.device("cpu")
        )
        before = k5.LAUNCHES
        with pytest.raises(ValueError, match="128, 256, 384"):
            k5.ablate_banded_cuda(*operands, "full")
        assert k5.LAUNCHES == before
    assert k5.CUDA_BAND_WORDS == (128, 256, 384)


def test_launch_wrappers_refuse_cpu_tensors():
    texts = torch.from_numpy(texts_for(0))
    jstar = torch.zeros(32, dtype=torch.int32)
    operands = k5.device_operands(k5.script_inputs(N), torch.device("cpu"))
    before = (k5.LAUNCHES, k6.LAUNCHES, k78.CARRY_LAUNCHES, k78.BCAST_LAUNCHES)
    for call in (
        lambda: k5.ablate_banded_cuda(*operands, "full"),
        lambda: k6.column_loop_cuda(texts, "empty"),
        lambda: k78.carry_scaling_cuda(texts, 3, 0, 0),
        lambda: k78.bcast_cuda(texts, jstar, 4),
    ):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    after = (k5.LAUNCHES, k6.LAUNCHES, k78.CARRY_LAUNCHES, k78.BCAST_LAUNCHES)
    assert after == before


def test_unknown_variants_and_configurations_are_refused():
    """On both routes: a configuration outside the script's lists never
    falls back to the plain version."""
    texts = torch.from_numpy(texts_for(0))
    jstar = torch.zeros(32, dtype=torch.int32)
    operands = k5.device_operands(k5.script_inputs(N), torch.device("cpu"))
    for call in (
        lambda: k5.ablate_banded(*operands, "noslide+noeq"),
        lambda: k5.ablate_banded_cuda(*operands, "nokogge"),
        lambda: k6.column_loop(texts, "bogus"),
        lambda: k6.column_loop_cuda(texts, "Rolls"),
        lambda: k78.carry_scaling(texts, 3, 40, 0),
        lambda: k78.carry_scaling_cuda(texts, 14, 80, 12),
        lambda: k78.bcast(texts, jstar, 5),
        lambda: k78.bcast_cuda(texts, jstar, 20),
    ):
        with pytest.raises(ValueError, match="variant|configuration|n_bcast"):
            call()
    with pytest.raises(ValueError, match="shape"):
        k78.bcast(texts, jstar[:8], 4)
    with pytest.raises(ValueError, match="int32"):
        k6.column_loop(texts.to(torch.int64), "empty")


MODULES = ("ablate_banded_kernel", "microbench_column_loop",
           "microbench_carry_scaling")
JAX_BLOCKED = "import sys; sys.modules['jax'] = None; "


def test_scripts_import_without_jax():
    imports = "; ".join(f"import floxer_tpu_torch.scripts.{m}" for m in MODULES)
    proc = subprocess.run(
        [sys.executable, "-c", JAX_BLOCKED + imports],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", MODULES)
def test_entry_point_without_a_gpu_exits_nonzero_silently(module):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    proc = subprocess.run(
        [
            sys.executable, "-c",
            JAX_BLOCKED + "import runpy; runpy.run_module("
            f"'floxer_tpu_torch.scripts.{module}', run_name='__main__')",
        ],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
    )
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "GPU" in proc.stderr


FAKE_NVCC = """#!/bin/sh
# writes its -o target; a source that holds BROKEN does not compile
out=""; src=""; prev=""
for arg in "$@"; do
  [ "$prev" = "-o" ] && out="$arg"
  case "$arg" in *.cu) src="$arg";; esac
  prev="$arg"
done
if [ -n "$src" ] && grep -q BROKEN "$src"; then echo "error in $src"; exit 1; fi
echo built > "$out"
"""


def test_each_source_set_builds_its_own_library(tmp_path, monkeypatch):
    """One nvcc per source, then a link, into a library named by the
    sources' hash; a failed compile raises and leaves no library. The
    aligner's, the scripts' and the bench's libraries share no source."""
    from floxer_tpu_torch.ops import _build

    assert [s.name for s in _build.ALIGNER.sources()] == [
        "fm_index.cu", "fm_sharded.cu", "frontier_search.cu",
        "myers_banded.cu", "myers_banded_cluster.cu",
        "myers_banded_wide.cu", "myers_large.cu", "myers_large_cluster.cu",
        "myers_small.cu", "select_anchors.cu", "traceback_banded.cu",
        "workqueue_search.cu",
    ]
    assert [s.name for s in _build.SCRIPTS.sources()] == [
        "ablate_banded_kernel.cu", "microbench_carry_scaling.cu",
        "microbench_column_loop.cu",
    ]
    assert [s.name for s in _build.BENCH.sources()] == ["k1w_lockstep.cu"]
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu"):
        (csrc / name).write_text("// a kernel\n")
    library = _build.KernelLibrary(csrc, "libtest", {})
    built = library.path()
    library._build(built)
    assert built.read_text() == "built\n"
    assert library.last_build_seconds is not None
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted([
        "libtest.lock", built.name, built.with_suffix(".log").name,
    ])
    (csrc / "b.cu").write_text("BROKEN\n")
    broken = library.path()
    assert broken != built
    with pytest.raises(RuntimeError, match="(?s)nvcc failed building libtest.*b.cu"):
        library._build(broken)
    assert not broken.exists()


def test_an_edited_header_changes_the_library(tmp_path):
    """A library's name hashes the headers beside its sources too (the
    aligner's K2 and K3 include csrc/myers_full_column.cuh, K1's two
    register kernels csrc/myers_banded_column.cuh, K9-K9l, K10, K11 and
    K12 csrc/fm_rank.cuh), and the headers it names from elsewhere (the
    scripts' K5 that same csrc/myers_banded_column.cuh), so an edited
    header is never served from a stale build; nvcc compiles the .cu files
    only."""
    from floxer_tpu_torch.ops import _build

    assert [h.name for h in _build.ALIGNER.headers()] == [
        "fm_rank.cuh", "myers_banded_column.cuh", "myers_full_column.cuh"
    ]
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include "a.cuh"\n')
    (csrc / "a.cuh").write_text("// one\n")
    library = _build.KernelLibrary(csrc, "libtest", {})
    assert [s.name for s in library.sources()] == ["a.cu"]
    before = library.path()
    (csrc / "a.cuh").write_text("// two\n")
    assert library.path() != before
    # the scripts' K5 includes the aligner's K1 column header from csrc/:
    # the scripts library (here over copies of its sources and that
    # header) hashes it too
    column = ROOT / "floxer_tpu_torch" / "csrc" / "myers_banded_column.cuh"
    assert column in _build.SCRIPTS.headers()
    scripts = tmp_path / "scripts"
    scripts.mkdir()
    for source in _build.SCRIPTS.sources():
        (scripts / source.name).write_bytes(source.read_bytes())
    shared = tmp_path / "aligner_csrc" / column.name
    shared.parent.mkdir()
    shared.write_bytes(column.read_bytes())
    library = _build.KernelLibrary(scripts, "libtest", {}, (shared,))
    before = library.path()
    shared.write_bytes(column.read_bytes() + b"// edited\n")
    assert library.path() != before


def test_the_scripts_library_compiles_with_the_column_headers_directory(
    tmp_path, monkeypatch
):
    """nvcc compiles each of the scripts' sources with -I<the directory of
    K1's column header>, which K5 includes by name."""
    from floxer_tpu_torch.ops import _build

    column = ROOT / "floxer_tpu_torch" / "csrc" / "myers_banded_column.cuh"
    assert _build.SCRIPTS.include_flags() == [f"-I{column.parent}"]
    shared = tmp_path / "include" / column.name
    shared.parent.mkdir()
    shared.write_text("// a header\n")
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu"):
        (csrc / name).write_text(f'#include "{column.name}"\n')
    library = _build.KernelLibrary(csrc, "libtest", {}, (shared,))
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(FAKE_NVCC_ARGS)
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    library._build(library.path())
    compiles = [line for line in library.log_path().read_text().splitlines()
                if " -c " in line]
    assert len(compiles) == 2
    assert all(f" -I{shared.parent} " in f"{line} " for line in compiles)


FAKE_NVCC_ARGS = """#!/bin/sh
# writes its -o target; a compile prints its arguments
out=""; prev=""
for arg in "$@"; do
  [ "$prev" = "-o" ] && out="$arg"
  prev="$arg"
done
case " $* " in *" -c "*) echo "nvcc $*";; esac
echo built > "$out"
"""


FAKE_NVCC_PTXAS = """#!/bin/sh
# writes its -o target; with -Xptxas -v it reports one kernel per source
out=""; src=""; prev=""; verbose=""
for arg in "$@"; do
  [ "$prev" = "-o" ] && out="$arg"
  [ "$prev" = "-Xptxas" ] && [ "$arg" = "-v" ] && verbose=1
  case "$arg" in *.cu) src="$arg";; esac
  prev="$arg"
done
if [ -n "$verbose" ] && [ -n "$src" ]; then
  k=$(basename "$src" .cu)
  echo "ptxas info    : Compiling entry function '_Z1${k}v' for 'sm_90a'"
  echo "ptxas info    : Function properties for _Z1${k}v"
  echo "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
  echo "ptxas info    : Used 42 registers, used 0 barriers"
fi
echo built > "$out"
"""


def test_ptxas_report_is_kept_from_the_build(tmp_path, monkeypatch):
    """Every source compiles with -Xptxas -v, and the compilers' output is
    kept beside the library, so its register and spill report comes from
    the build itself."""
    from floxer_tpu_torch.ops import _build

    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(FAKE_NVCC_PTXAS)
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu"):
        (csrc / name).write_text("// a kernel\n")
    library = _build.KernelLibrary(csrc, "libtest", {})
    library._build(library.path())
    assert library.log_path().exists()
    assert library.ptxas_usage() == {
        f"_Z1{k}v": {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                     "registers": 42}
        for k in "ab"
    }


SASS = """
\t\tFunction : _Z4loopv
        /*0000*/                   MOV R1, c[0x0][0x28] ;      /* 0x000 */
        /*0010*/                   IADD3 R2, R1, 0x1, RZ ;     /* 0x000 */
        /*0020*/               @P0 BRA 0x40 ;                  /* 0x000 */
        /*0030*/                   LOP3.LUT R3, R2, R1, RZ, 0x96, !PT ;
        /*0040*/                   SHF.R.U32.HI R2, RZ, 0x1, R2 ;
        /*0050*/               @!P1 BRA 0x10 ;
        /*0060*/                   IMAD R4, R2, R3, RZ ;
        /*0070*/                   IADD3 R4, R4, 0x1, RZ ;
        /*0080*/               @!P2 BRA 0x60 ;
        /*0090*/               @!P3 BRA 0x10 ;
        /*00a0*/                   EXIT ;
        /*00b0*/                   BRA 0xb0;
\t\tFunction : _Z5flatv
        /*0000*/                   EXIT ;
"""


def test_sass_loops_counts_innermost_loops():
    """sass_loops reads cuobjdump -sass: a branch back to an earlier
    address closes a loop; only loops holding no other loop count, a
    forward branch inside one does not split it, and the trailing
    self-branch is no loop."""
    from floxer_tpu_torch.ops import _build

    assert _build.sass_loops(SASS) == {"_Z4loopv": [5, 3], "_Z5flatv": []}
