"""The parsers of the program's end-of-job lines, on lines as it writes
them (captured from a job through the server)."""

from benchmark import logs

CAPTURED = [
    "successfully parsed CLI input ... starting",
    "reusing cached index for /w/build/benchmark/index/genome_300000x2_seed3.fxi",
    "aligning queries against 2 references and writing output file to /t/job3.sam",
    "finished aligning successfully in 11.37 seconds",
    "stage split: search=4.02s verify=7.91s finalize=1.20s "
    "device_kernel=0.31s fused_dispatches=12 launches=K1:59,K2:33,K3:73,"
    "K4:0,K9:0,K9x:0,K9l:0,K10:8,K11:0,K11s:0,K12:0,K13:0,K13l:0",
]


def test_align_seconds():
    assert logs.align_seconds(CAPTURED) == 11.37
    assert logs.align_seconds(CAPTURED[:3]) is None
    assert logs.align_seconds(
        ["finished aligning successfully in 0.04 seconds (0 min)"]) == 0.04


def test_stage_split():
    split = logs.stage_split(CAPTURED)
    assert (split["search"], split["verify"], split["finalize"]) == (
        4.02, 7.91, 1.20)
    assert split["launches"]["K1"] == 59
    assert split["launches"]["K10"] == 8
    assert len(split["launches"]) == 13
    assert logs.stage_split(CAPTURED[:4]) is None
