"""End-to-end round-trip tests — the reference's test strategy
(util/test_script.sh: 17 compress/decompress cycles verified byte-exact
with cmp; reorder mode verified order-insensitively via sort|cmp).
"""
import gzip
import pathlib
import subprocess

import pytest

from spring_tpu import api, cli


def _read(path):
    p = pathlib.Path(path)
    data = p.read_bytes()
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    return data


def _norm(data: bytes) -> bytes:
    return data if data.endswith(b"\n") or not data else data + b"\n"


def assert_same(a, b):
    assert _norm(_read(a)) == _norm(_read(b))


def assert_same_multiset(a, b, fasta=False):
    """Order-insensitive record multiset equality (reference
    util/test_script.sh:79-92 uses sort|cmp)."""
    def records(p):
        lines = _read(p).decode().splitlines()
        n = 2 if fasta else 4
        return sorted(tuple(lines[i:i + n]) for i in range(0, len(lines), n))
    assert records(a) == records(b)


@pytest.mark.parametrize("reorder", [False, True])
def test_se_long_lossless(fq1, tmp_path, reorder):
    arc = tmp_path / "a.spring"
    out = tmp_path / "out.fastq"
    opts = api.CompressOptions(long_mode=True, reorder=reorder, verbose=False)
    api.compress([fq1], str(arc), opts)
    api.decompress(str(arc), [str(out)], verbose=False)
    assert_same(fq1, out)  # long mode always preserves order


def test_pe_long_lossless(fq1, fq2, tmp_path):
    arc = tmp_path / "a.spring"
    o1, o2 = tmp_path / "o1.fastq", tmp_path / "o2.fastq"
    api.compress([fq1, fq2], str(arc),
                 api.CompressOptions(long_mode=True, verbose=False))
    api.decompress(str(arc), [str(o1), str(o2)], verbose=False)
    assert_same(fq1, o1)
    assert_same(fq2, o2)


def test_fasta_long(fa1, tmp_path):
    arc = tmp_path / "a.spring"
    out = tmp_path / "out.fasta"
    api.compress([fa1], str(arc),
                 api.CompressOptions(long_mode=True, fasta_input=True,
                                     verbose=False))
    api.decompress(str(arc), [str(out)], verbose=False)
    assert_same(fa1, out)


def test_gz_input_and_output(fq1_gz, fq1, tmp_path):
    arc = tmp_path / "a.spring"
    out = tmp_path / "out.fastq.gz"
    api.compress([fq1_gz], str(arc),
                 api.CompressOptions(long_mode=True, verbose=False))
    api.decompress(str(arc), [str(out)], gzipped=True, verbose=False)
    assert_same(fq1, out)


def test_long_range_decompress(fq1, tmp_path):
    arc = tmp_path / "a.spring"
    out = tmp_path / "out.fastq"
    api.compress([fq1], str(arc),
                 api.CompressOptions(long_mode=True, verbose=False))
    api.decompress(str(arc), [str(out)], read_range=(9, 17), verbose=False)
    lines = _read(fq1).splitlines()
    want = b"\n".join(b"\n".join(lines[4 * i: 4 * i + 4]) for i in range(9, 17))
    assert _norm(_read(out)) == _norm(want + b"\n")


def test_no_quality_no_ids(fq1, tmp_path):
    arc = tmp_path / "a.spring"
    out = tmp_path / "out.fastq"
    api.compress([fq1], str(arc),
                 api.CompressOptions(long_mode=True, preserve_quality=False,
                                     preserve_id=False, verbose=False))
    api.decompress(str(arc), [str(out)], verbose=False)
    lines = _read(out).splitlines()
    orig = _read(fq1).splitlines()
    assert len(lines) == 2 * (len(orig) // 4)
    assert lines[1::2] == orig[1::4]  # reads survive


def test_thread_count_asymmetry(fq1, fq2, tmp_path):
    # compress with 8 threads, decompress with 5 (reference
    # util/test_script.sh:69-76)
    arc = tmp_path / "a.spring"
    o1, o2 = tmp_path / "o1.fastq", tmp_path / "o2.fastq"
    api.compress([fq1, fq2], str(arc),
                 api.CompressOptions(long_mode=True, num_threads=8,
                                     verbose=False))
    api.decompress(str(arc), [str(o1), str(o2)], num_threads=5, verbose=False)
    assert_same(fq1, o1)
    assert_same(fq2, o2)


def test_cli_roundtrip(fq1, tmp_path):
    arc = tmp_path / "a.spring"
    out = tmp_path / "out.fastq"
    rc = cli.main(["-c", "-i", fq1, "-o", str(arc), "-l", "--quiet"])
    assert rc == 0
    rc = cli.main(["-d", "-i", str(arc), "-o", str(out), "--quiet"])
    assert rc == 0
    assert_same(fq1, out)


def test_cli_range(fq1, tmp_path):
    arc = tmp_path / "a.spring"
    out = tmp_path / "out.fastq"
    assert cli.main(["-c", "-i", fq1, "-o", str(arc), "-l", "--quiet"]) == 0
    assert cli.main(["-d", "-i", str(arc), "-o", str(out),
                     "--decompress-range", "1", "5", "--quiet"]) == 0
    assert len(_read(out).splitlines()) == 20


def test_cli_bad_input_errors(tmp_path):
    assert cli.main(["-c", "-i", "/nonexistent.fastq",
                     "-o", str(tmp_path / "x"), "-l", "--quiet"]) == 1


def test_corrupt_archive_errors(fq1, tmp_path):
    arc = tmp_path / "a.spring"
    api.compress([fq1], str(arc),
                 api.CompressOptions(long_mode=True, verbose=False))
    data = bytearray(arc.read_bytes())
    data[2048:2080] = b"\0" * 32  # stomp on stream data
    (tmp_path / "bad.spring").write_bytes(bytes(data))
    with pytest.raises(Exception):
        api.decompress(str(tmp_path / "bad.spring"),
                       [str(tmp_path / "out.fastq")], verbose=False)


def test_corrupt_archive_fuzz(fq1, tmp_path):
    """Random single-byte corruptions anywhere in the archive must yield a
    clean Python exception or a correct round-trip (a flip in tar padding
    or an unread member is benign) — never a crash or wrong output that
    goes undetected by the stream checksums/validators."""
    import numpy as np
    arc = tmp_path / "a.spring"
    api.compress([fq1], str(arc),
                 api.CompressOptions(long_mode=True, verbose=False))
    _fuzz_archive(fq1, arc, tmp_path, flips=40)
    api.compress([fq1], str(arc), api.CompressOptions(verbose=False))
    _fuzz_archive(fq1, arc, tmp_path, flips=25)   # short-mode streams


def test_member_crc_detects_payload_flip(fq1, tmp_path):
    """The entropy codecs carry no checksum of their own: a flipped byte
    inside a stored member's payload must still fail the read (manifest
    CRC32), not decode into wrong records."""
    import tarfile
    arc = tmp_path / "a.spring"
    api.compress([fq1], str(arc), api.CompressOptions(verbose=False))
    with tarfile.open(arc) as t:
        m = t.getmember("seq.0")
    data = bytearray(arc.read_bytes())
    data[m.offset_data + m.size // 2] ^= 0x5A
    (tmp_path / "bad.spring").write_bytes(bytes(data))
    with pytest.raises(RuntimeError, match="seq.0 is corrupt"):
        api.decompress(str(tmp_path / "bad.spring"),
                       [str(tmp_path / "out.fastq")], verbose=False)


def _fuzz_archive(fq1, arc, tmp_path, flips):
    import numpy as np
    good = open(fq1, "rb").read()
    data = bytearray(arc.read_bytes())
    rng = np.random.default_rng(11)
    bad_path = tmp_path / "bad.spring"
    out = tmp_path / "out.fastq"
    outcomes = {"error": 0, "intact": 0}
    for _ in range(flips):
        mut = bytearray(data)
        pos = int(rng.integers(0, len(mut)))
        mut[pos] ^= int(rng.integers(1, 256))
        bad_path.write_bytes(bytes(mut))
        try:
            api.decompress(str(bad_path), [str(out)], verbose=False)
        except Exception:
            outcomes["error"] += 1
            continue
        # decode "succeeded": the flip must have been benign
        assert out.read_bytes() == good, f"undetected corruption at {pos}"
        outcomes["intact"] += 1
    # sanity: the fuzz actually hit live bytes sometimes
    assert outcomes["error"] > 0


def test_archive_reader_thread_safety(tmp_path):
    """tarfile's shared-handle reads are racy; ArchiveReader must serve
    concurrent get() calls with correct bytes (os.pread)."""
    from concurrent.futures import ThreadPoolExecutor

    from spring_tpu.io.container import ArchiveReader, ArchiveWriter
    from spring_tpu.params import CompressionParams

    arc = str(tmp_path / "t.stpu")
    blobs = {f"m.{i}": bytes([i % 251]) * (1000 + 37 * i) for i in range(64)}
    with ArchiveWriter(arc) as w:
        for k, v in blobs.items():
            w.add(k, v)
        w.finish(CompressionParams())
    with ArchiveReader(arc) as r:
        with ThreadPoolExecutor(max_workers=8) as pool:
            for _ in range(5):
                got = list(pool.map(lambda k: (k, r.get(k)), blobs))
                assert all(blobs[k] == v for k, v in got)


def test_recompression_deterministic(fq1, tmp_path):
    """Byte-identical archives across runs — stronger than the reference,
    whose -r output is thread-schedule-dependent (src/reorder.h lock
    races). Everything here is race-free by construction: XLA programs,
    sort-based claims, per-block codecs, fixed container order."""
    a1 = tmp_path / "a1.stpu"
    a2 = tmp_path / "a2.stpu"
    opts = api.CompressOptions(num_threads=4, verbose=False, reorder=True)
    api.compress([fq1], str(a1), opts)
    api.compress([fq1], str(a2), opts)
    assert a1.read_bytes() == a2.read_bytes()


@pytest.mark.parametrize("reorder", [False, True])
def test_se_variable_151bp_short_mode(tmp_path, reorder):
    """Variable lengths up to 151 bp (W = 10 packed words): reads past
    128 bases exercise the three-row consensus word fetch in
    second_chance (grid varlen failure, round 3) and the variable-length
    rlen/noise streams."""
    from spring_tpu.utils import synth
    fq = tmp_path / "v.fastq"
    synth.make_se(str(fq), 4000, genome_size=60_000, seed=13,
                  len_range=(36, 151))
    arc = tmp_path / "v.stpu"
    out = tmp_path / "v.out.fastq"
    api.compress([str(fq)], str(arc),
                 api.CompressOptions(reorder=reorder, verbose=False))
    api.decompress(str(arc), [str(out)], verbose=False)
    if reorder:
        assert_same_multiset(str(fq), str(out))
    else:
        assert_same(str(fq), str(out))


def test_pe_variable_151bp_short_mode(tmp_path):
    from spring_tpu.utils import synth
    f1, f2 = tmp_path / "v1.fastq", tmp_path / "v2.fastq"
    synth.make_pe(str(f1), str(f2), 2000, genome_size=60_000, seed=14,
                  len_range=(36, 151))
    arc = tmp_path / "v.stpu"
    o1, o2 = tmp_path / "o1.fastq", tmp_path / "o2.fastq"
    api.compress([str(f1), str(f2)], str(arc),
                 api.CompressOptions(verbose=False))
    api.decompress(str(arc), [str(o1), str(o2)], verbose=False)
    assert_same(str(f1), str(o1))
    assert_same(str(f2), str(o2))


def test_se_long_reads_600_to_5000bp(tmp_path):
    """Long mode's whole point is reads past the 511 bp short-mode cap
    (reference README.md:11, -l flag) — round-trip 600-5000 bp reads,
    plain and gz output, plus a range decode (VERDICT r3 next #7)."""
    from spring_tpu.utils import synth
    fq = tmp_path / "long.fastq"
    synth.make_se(str(fq), 300, read_len=5000, genome_size=200_000,
                  len_range=(600, 5000), seed=9)
    arc = tmp_path / "a.spring"
    out = tmp_path / "out.fastq"
    api.compress([str(fq)], str(arc),
                 api.CompressOptions(long_mode=True, verbose=False))
    api.decompress(str(arc), [str(out)], verbose=False)
    assert_same(fq, out)
    # gz output
    outgz = tmp_path / "out.fastq.gz"
    api.decompress(str(arc), [str(outgz)], gzipped=True, verbose=False)
    assert_same(fq, outgz)
    # range decode straddling a block boundary (long blocks are 10000
    # reads; use an inner slice to exercise the trim path)
    outr = tmp_path / "range.fastq"
    api.decompress(str(arc), [str(outr)], read_range=(37, 170),
                   verbose=False)
    lines = _read(fq).splitlines()
    want = b"\n".join(b"\n".join(lines[4 * i: 4 * i + 4])
                      for i in range(37, 170))
    assert _norm(_read(outr)) == _norm(want + b"\n")


def test_pe_long_reads_2000bp(tmp_path):
    from spring_tpu.utils import synth
    f1 = tmp_path / "l1.fastq"
    f2 = tmp_path / "l2.fastq"
    synth.make_pe(str(f1), str(f2), 150, read_len=2000,
                  genome_size=120_000, seed=12)
    arc = tmp_path / "a.spring"
    o1, o2 = tmp_path / "o1.fastq", tmp_path / "o2.fastq"
    api.compress([str(f1), str(f2)], str(arc),
                 api.CompressOptions(long_mode=True, verbose=False))
    api.decompress(str(arc), [str(o1), str(o2)], verbose=False)
    assert_same(f1, o1)
    assert_same(f2, o2)
