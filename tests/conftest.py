import os

# Unit tests run on the CPU backend, with a virtual 8-device mesh for the
# sharding tests; the GPU path is exercised by chip_smoke.py and bench.py.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import gzip  # noqa: E402
import pathlib  # noqa: E402

import jax  # noqa: E402
import pytest  # noqa: E402

# also pin the config in case a plugin imported jax before this file ran
jax.config.update("jax_platforms", "cpu")

# Round-trip fixtures in the shape of the reference CI's test files
# (util/test_1.fastq, util/test_2.fastq: 100 records x 2 files, 100 bp):
# seeded synthetic paired-end reads with variable lengths, N bases and
# 40-level Phred qualities, plus the FASTA and gzip forms derived from them.
FIXTURE_PAIRS = 100


def _fastq_to_fasta(src: pathlib.Path, dst: pathlib.Path) -> None:
    lines = src.read_bytes().splitlines()
    out = bytearray()
    for i in range(0, len(lines), 4):
        out += b">" + lines[i][1:] + b"\n" + lines[i + 1] + b"\n"
    dst.write_bytes(bytes(out))


@pytest.fixture(scope="session")
def fixture_dir(tmp_path_factory) -> pathlib.Path:
    from spring_tpu.utils import synth
    d = tmp_path_factory.mktemp("fixtures")
    fq = [d / "test_1.fastq", d / "test_2.fastq"]
    synth.make_pe(str(fq[0]), str(fq[1]), FIXTURE_PAIRS, read_len=100,
                  genome_size=3000, seed=2018, len_range=(60, 100),
                  qual_levels=40, n_rate=0.005)
    for i, f in enumerate(fq, 1):
        _fastq_to_fasta(f, d / f"test_{i}.fasta")
        (d / f"test_{i}.fastq.gz").write_bytes(
            gzip.compress(f.read_bytes(), mtime=0))
    return d


@pytest.fixture
def fq1(fixture_dir) -> str:
    return str(fixture_dir / "test_1.fastq")


@pytest.fixture
def fq2(fixture_dir) -> str:
    return str(fixture_dir / "test_2.fastq")


@pytest.fixture
def fa1(fixture_dir) -> str:
    return str(fixture_dir / "test_1.fasta")


@pytest.fixture
def fa2(fixture_dir) -> str:
    return str(fixture_dir / "test_2.fasta")


@pytest.fixture
def fq1_gz(fixture_dir) -> str:
    return str(fixture_dir / "test_1.fastq.gz")


@pytest.fixture
def fq2_gz(fixture_dir) -> str:
    return str(fixture_dir / "test_2.fastq.gz")
