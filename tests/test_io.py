"""Unit tests for packing, FASTQ IO, id patterns, quality tables."""
import numpy as np
import pytest

from spring_tpu.io import fastq, ids, packing
from spring_tpu.pipeline import quality


def test_pack_unpack_2bit():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=(37, 101), dtype=np.uint8)
    lens = rng.integers(1, 102, size=37).astype(np.int32)
    packed = packing.pack_codes(codes)
    assert packed.shape == (37, 7)
    out = packing.unpack_codes(packed, 101)
    np.testing.assert_array_equal(out, codes)


def test_pack_unpack_4bit():
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 5, size=(10, 33), dtype=np.uint8)
    out = packing.unpack_codes_4bit(packing.pack_codes_4bit(codes), 33)
    np.testing.assert_array_equal(out, codes)


def test_strings_to_codes_roundtrip():
    reads = [b"ACGTN", b"A", b"TTTTTTTTTT"]
    codes, lens = packing.strings_to_codes(reads, 10)
    assert list(lens) == [5, 1, 10]
    assert packing.codes_to_strings(codes, lens) == reads


def test_revcomp():
    codes, lens = packing.strings_to_codes([b"ACGTN", b"AACC"], 5)
    rc = packing.revcomp_codes(codes, lens)
    assert packing.codes_to_strings(rc, lens) == [b"NACGT", b"GGTT"]


def test_bitstream_2bit():
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, size=(5, 13), dtype=np.uint8)
    lens = np.array([13, 5, 0, 1, 13], dtype=np.int32)
    stream = packing.codes_to_bitstream_2bit(codes, lens)
    flat = packing.bitstream_2bit_to_flat(stream, int(lens.sum()))
    want = np.concatenate([codes[i, :lens[i]] for i in range(5)])
    np.testing.assert_array_equal(flat, want)


def test_fastq_block_reader(fq1):
    blocks = list(fastq.read_blocks(fq1, 30))
    assert [len(b) for b in blocks] == [30, 30, 30, 10]
    with open(fq1, "rb") as f:
        lines = f.read().splitlines()
    # every record of every block, field by field, against the raw lines
    recs = [(i, s, q) for b in blocks
            for i, s, q in zip(b.ids, b.seqs, b.quals)]
    assert recs == list(zip(lines[0::4], lines[1::4], lines[3::4]))
    assert blocks[0].ids[0] == b"@SYN.1/1"
    assert len({len(s) for _, s, _ in recs}) > 1     # variable lengths


def test_fasta_block_reader(fa1):
    blocks = list(fastq.read_blocks(fa1, 1000, fasta=True))
    assert sum(len(b) for b in blocks) == 100
    assert blocks[0].quals == []


def test_gz_reader_matches_plain(fq1, fq1_gz):
    a = list(fastq.read_blocks(fq1, 1000))[0]
    b = list(fastq.read_blocks(fq1_gz, 1000))[0]
    assert a.seqs == b.seqs and a.ids == b.ids and a.quals == b.quals


@pytest.mark.parametrize("id1,id2,code", [
    (b"SRR554369.1 1/1", b"SRR554369.1 1/2", 1),
    (b"abc", b"abd", 0),
    (b"read/1", b"read/2", 1),
    (b"same", b"same", 2),
    (b"inst:1:2 1:N:0:ATC", b"inst:1:2 2:N:0:ATC", 3),
])
def test_id_patterns(id1, id2, code):
    assert ids.find_id_pattern(id1, id2) == code
    if code:
        assert ids.check_id_pattern(id1, id2, code)
        assert ids.modify_id(id1, code) == id2


def test_illumina_binning_table():
    t = quality.illumina_binning_table()
    assert t[33 + 2] == 33 + 6
    assert t[33 + 40] == 33 + 40
    assert t[33 + 12] == 33 + 15
    # idempotent: binned values map to themselves
    for q in (0, 6, 15, 22, 27, 33, 37, 40):
        assert t[t[33 + q]] == t[33 + q]


def test_binary_binning_table():
    t = quality.binary_binning_table(20, 40, 6)
    assert t[33 + 19] == 33 + 6
    assert t[33 + 20] == 33 + 40


def test_multi_segment_parse_matches_single(tmp_path, monkeypatch):
    """parse_packed_into in >1 segment (page-release path) must produce
    byte-identical arrays to the single-segment parse."""
    import numpy as np
    from spring_tpu.io import fastq_native as fn
    from spring_tpu.utils import synth
    fq = str(tmp_path / "seg.fastq")
    synth.make_se(fq, 20000, read_len=73)

    def parse_all():
        buf = fn.open_buf(fq)
        info = fn.scan_buf(buf, fq)
        ml, n = info.maxlen, info.n
        W = -(-ml // 16)
        packed = np.empty((n, W), np.uint32)
        lengths = np.empty(n, np.int32)
        quals = np.empty((n, ml), np.uint8)
        idbuf = np.empty(info.idbytes, np.uint8)
        idlens = np.empty(n, np.uint32)
        exc = fn.parse_packed_into(buf, fq, info, ml, packed, lengths,
                                   quals, idbuf, idlens)
        return packed, lengths, quals, idbuf, idlens, exc

    one = parse_all()
    monkeypatch.setattr(fn, "_SEG_RECORDS", 4096)
    many = parse_all()
    for a, b in zip(one, many):
        np.testing.assert_array_equal(a, b)
