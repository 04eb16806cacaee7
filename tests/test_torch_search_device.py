"""The port's chunk device search (floxer_tpu_torch.search_device
.DeviceSearcher.search_seeds_many, the work queue's plain version on the
CPU) against the reference's DeviceSearcher (XLA on the CPU) and the host
Searcher, on the cases of tests/test_search_device.py: caps binding or
not, empty and tiny chunks, long seeds to the host redo, one dispatch a
chunk. Every comparison is integer equality of each seed's counters and
anchor rows. The reference's other branches (the legacy block loop, device
select, the per-query frontier) equal the host search; the chunk frontier,
which the port does not carry, raises."""

import numpy as np
import pytest
import torch

from floxer_tpu import pex as ref_pex
from floxer_tpu import search_device as ref_sd
from floxer_tpu import search_host as ref_host_search
from floxer_tpu.index.device_index import DeviceIndex as RefDeviceIndex
from floxer_tpu.index.fmindex import FmIndex as RefFmIndex
from floxer_tpu_torch import pex, search_device, search_host, tracing
from floxer_tpu_torch.index.device_index import DeviceIndex
from floxer_tpu_torch.index.fmindex import FmIndex

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def indexes():
    rng = np.random.default_rng(17)
    sequences = [
        rng.integers(1, 5, size=3000).astype(np.uint8),
        rng.integers(1, 5, size=900).astype(np.uint8),
    ]
    ref_host = RefFmIndex(sequences)
    host = FmIndex(sequences)
    return (ref_host, RefDeviceIndex.from_host(ref_host), host,
            DeviceIndex.from_host(host, CPU), sequences)


def _config(module, kwargs):
    kwargs = dict(kwargs)
    if "anchor_group_order" in kwargs:
        kwargs["anchor_group_order"] = module.AnchorGroupOrder(
            kwargs["anchor_group_order"]
        )
    if "anchor_choice_strategy" in kwargs:
        kwargs["anchor_choice_strategy"] = module.AnchorChoiceStrategy(
            kwargs["anchor_choice_strategy"]
        )
    return module.SearchConfig(**kwargs)


def searchers(indexes, config_kwargs=None):
    """(port host Searcher, port DeviceSearcher, reference
    DeviceSearcher) with the same configuration."""
    ref_host, ref_device, host, device, sequences = indexes
    config_kwargs = config_kwargs or {}
    host_searcher = search_host.Searcher(
        index=host, num_reference_sequences=len(sequences),
        config=_config(search_host, config_kwargs),
    )
    ref_searcher = ref_host_search.Searcher(
        index=ref_host, num_reference_sequences=len(sequences),
        config=_config(ref_host_search, config_kwargs),
    )
    return (host_searcher,
            search_device.DeviceSearcher(host_searcher, device),
            ref_sd.DeviceSearcher(ref_searcher, ref_device))


def chunk_jobs(sequences, rng, num_queries, seed_len_range, k):
    """tests/test_search_device.py's synthetic chunk: queries sampled from
    the text with scattered mutations, PEX-like seed lists of varying
    lengths, as (seed tuples, query)."""
    jobs = []
    for q in range(num_queries):
        source = sequences[q % len(sequences)]
        qlen = int(rng.integers(60, 120))
        start = int(rng.integers(0, len(source) - qlen))
        query = source[start:start + qlen].copy()
        for _ in range(int(rng.integers(0, 4))):
            pos = int(rng.integers(0, qlen))
            query[pos] = 1 + (query[pos] % 4)
        seeds = []
        pos = leaf = 0
        while pos + seed_len_range[0] <= qlen:
            length = min(int(rng.integers(*seed_len_range)), qlen - pos)
            if length < seed_len_range[0]:
                break
            seeds.append((pos, length, int(rng.integers(0, k + 1)), leaf))
            pos += length
            leaf += 1
        if seeds:
            jobs.append((seeds, query))
    return jobs


def of_package(jobs, module):
    """The jobs with each package's own Seed objects."""
    return [([module.Seed(*s) for s in seeds], query) for seeds, query in jobs]


def result_view(result):
    """(counters, anchor rows) per seed, normalized across SoA/object."""
    per_seed = []
    for aos in result.anchors_by_seed:
        if aos.rows is not None:
            rows = [tuple(r) for r in aos.rows.tolist()]
        else:
            rows = [(a.reference_id, a.reference_position, a.num_errors)
                    for anchors in aos.anchors_by_reference for a in anchors]
        per_seed.append((aos.num_kept_useful_anchors, aos.num_kept_raw_anchors,
                         aos.num_excluded_raw_anchors_by_soft_cap, rows))
    return per_seed


def assert_all_equal(indexes, jobs, config_kwargs=None):
    """The port's device search equals the port's host search and the
    reference's device search, job by job."""
    host_searcher, device_searcher, ref_searcher = searchers(
        indexes, config_kwargs
    )
    got = device_searcher.search_seeds_many(of_package(jobs, pex))
    want = host_searcher.search_seeds_many(of_package(jobs, pex))
    ref_got = ref_searcher.search_seeds_many(of_package(jobs, ref_pex))
    assert len(got) == len(want) == len(ref_got) == len(jobs)
    for j, (g, w, r) in enumerate(zip(got, want, ref_got)):
        assert result_view(g) == result_view(w), f"job {j} vs host"
        assert result_view(g) == result_view(r), f"job {j} vs reference"


@pytest.mark.parametrize("case", [
    ("binding", {"max_num_anchors_hard": 5, "max_num_anchors_soft": 3}),
    ("binding", {"max_num_anchors_hard": 12, "max_num_anchors_soft": 4,
                 "anchor_choice_strategy": "first_reported"}),
    ("binding", {"max_num_anchors_hard": 8, "max_num_anchors_soft": 8,
                 "anchor_group_order": "errors_first"}),
    ("mixed", {}),
    ("mixed", {"anchor_group_order": "errors_first",
               "anchor_choice_strategy": "full_groups"}),
    ("mixed", {"erase_useless_anchors": False}),
    ("not_binding", {}),
])
def test_chunk_search_matches_host_and_reference(indexes, case):
    """Caps binding (short seeds, tiny hard/soft caps), a mixed chunk
    under each group order and choice strategy, and long seeds whose caps
    never bind."""
    name, config_kwargs = case
    sequences = indexes[-1]
    if name == "binding":
        jobs = chunk_jobs(sequences, np.random.default_rng(77), 14, (6, 12), 1)
    elif name == "mixed":
        jobs = chunk_jobs(sequences, np.random.default_rng(2024), 12,
                          (10, 18), 2)
    else:
        jobs = chunk_jobs(sequences, np.random.default_rng(31), 10, (22, 30),
                          2)
    assert len(jobs) >= 10
    assert_all_equal(indexes, jobs, config_kwargs)


def test_chunk_search_empty_and_tiny(indexes):
    sequences = indexes[-1]
    host_searcher, device_searcher, _ = searchers(indexes)
    assert device_searcher.search_seeds_many([]) == []
    jobs = [([(0, 14, 0, 0)], sequences[0][50:80].copy())]
    assert_all_equal(indexes, jobs)


def test_long_seeds_go_to_the_host_redo(indexes, monkeypatch):
    """Seeds longer than _MAX_DEVICE_PATTERN never reach the device
    search and still give host-identical results through the native
    redo; the redo counter counts them."""
    sequences = indexes[-1]
    rng = np.random.default_rng(55)
    long_len = search_device._MAX_DEVICE_PATTERN + 20
    jobs = []
    for _ in range(4):
        start = int(rng.integers(0, len(sequences[0]) - (long_len + 60)))
        query = sequences[0][start:start + long_len + 60].copy()
        for _ in range(2):
            pos = int(rng.integers(0, len(query)))
            query[pos] = 1 + (query[pos] % 4)
        jobs.append(([(0, 14, 1, 0), (14, long_len, 2, 1),
                      (14 + long_len, 16, 0, 2)], query))
    dispatched = []
    original = search_device.DeviceSearcher._dispatch_workqueue

    def traced(self, patterns, *args):
        dispatched.append(patterns.shape[1])
        return original(self, patterns, *args)

    monkeypatch.setattr(search_device.DeviceSearcher, "_dispatch_workqueue",
                        traced)
    long_before = search_device.DeviceSearcher.redo_long
    assert_all_equal(indexes, jobs)
    assert dispatched and max(dispatched) <= search_device._MAX_DEVICE_PATTERN
    assert search_device.DeviceSearcher.redo_long - long_before == 4


def test_overflowed_chunk_goes_to_the_host_redo(indexes, monkeypatch):
    """A work queue that overflows (a report capacity too small for the
    chunk, even after its one retry) sends every seed to the native
    redo, and the output still equals the host's."""
    from floxer_tpu_torch import search_queue

    sequences = indexes[-1]
    jobs = chunk_jobs(sequences, np.random.default_rng(7), 6, (6, 10), 1)
    # the report capacity becomes 1 (4 on the retry)
    monkeypatch.setattr(search_device, "report_capacity", lambda _: 1)
    before = search_device.DeviceSearcher.redo_overflow
    retries = search_queue.RETRIES
    assert_all_equal(indexes, jobs)
    assert search_device.DeviceSearcher.redo_overflow > before
    assert search_queue.RETRIES > retries


def test_chunk_search_is_one_dispatch(indexes):
    """The whole chunk, several error and length classes, in ONE
    work-queue dispatch."""
    sequences = indexes[-1]
    jobs = chunk_jobs(sequences, np.random.default_rng(99), 10, (8, 20), 2)
    assert len({s[2] for seeds, _ in jobs for s in seeds}) > 1
    _, device_searcher, _ = searchers(indexes)
    before = search_device.DeviceSearcher._chunk_dispatches
    device_searcher.search_seeds_many(of_package(jobs, pex))
    assert search_device.DeviceSearcher._chunk_dispatches == before + 1


@pytest.mark.parametrize("branch", [
    "FLOXER_TPU_SEARCH_NO_CHUNK_FUSE", "FLOXER_TPU_DEVICE_SELECT",
    "FLOXER_TPU_NO_NATIVE_SELECT", "FLOXER_TPU_SEARCH_ENGINE",
    "no_native_library", "search_seeds",
])
def test_unported_branches_raise(indexes, monkeypatch, branch):
    """The reference's other search branches, now ported, each equal the
    host search: the legacy block loop (FLOXER_TPU_SEARCH_NO_CHUNK_FUSE:
    frontier searches of 256-seed blocks, no work-queue dispatch), device
    select (FLOXER_TPU_DEVICE_SELECT), the per-query frontier without the
    native select (FLOXER_TPU_NO_NATIVE_SELECT, or no native library) and
    search_seeds itself. The chunk frontier
    (FLOXER_TPU_SEARCH_ENGINE=frontier), an ablation, still raises naming
    it, instead of running the work queue."""
    from floxer_tpu_torch import native

    sequences = indexes[-1]
    jobs = of_package(
        chunk_jobs(sequences, np.random.default_rng(1), 2, (10, 14), 1), pex
    )
    host_searcher, device_searcher, _ = searchers(indexes)
    before = search_device.DeviceSearcher._chunk_dispatches
    if branch == "search_seeds":
        got = device_searcher.search_seeds(*jobs[0])
        want = host_searcher.search_seeds(*jobs[0])
        assert result_view(got) == result_view(want)
        return
    if branch == "FLOXER_TPU_SEARCH_ENGINE":
        monkeypatch.setenv(branch, "frontier")
        with pytest.raises(NotImplementedError, match="frontier"):
            device_searcher.search_seeds_many(jobs)
        assert search_device.DeviceSearcher._chunk_dispatches == before
        return
    want = host_searcher.search_seeds_many(jobs)
    if branch == "no_native_library":
        monkeypatch.setattr(native, "get_library", lambda: None)
    else:
        monkeypatch.setenv(branch, "1")
    with tracing.job() as job:
        got = device_searcher.search_seeds_many(jobs)
    assert len(got) == len(want) == len(jobs)
    for j, (g, w) in enumerate(zip(got, want)):
        assert result_view(g) == result_view(w), f"job {j} vs host"
    # device select finds the groups with one work-queue dispatch, the
    # others with none; each runs its own stage
    dispatches = int(branch == "FLOXER_TPU_DEVICE_SELECT")
    assert search_device.DeviceSearcher._chunk_dispatches == before + dispatches
    stage = {
        "FLOXER_TPU_SEARCH_NO_CHUNK_FUSE": "blocks",
        "FLOXER_TPU_DEVICE_SELECT": "device_select",
    }.get(branch, "frontier")
    assert job.seconds(f"search.device.{stage}") > 0
