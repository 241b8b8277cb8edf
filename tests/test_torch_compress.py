"""The slice end to end on the CPU: megalania_tpu_torch's compressor
emits the same bytes as megalania_tpu's for the same seed, and the
ported CLI round-trips a file."""
import lzma
import os

import pytest

from megalania_tpu import compressor as JCM
from megalania_tpu.anneal.config import AnnealConfig as JConfig
from megalania_tpu_torch import cli, compressor as TCM
from megalania_tpu_torch.anneal.config import AnnealConfig as TConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIBC = open(os.path.join(ROOT, "tools", "corpus", "libc.so"), "rb").read()


@pytest.mark.parametrize("total_moves", [0, 16])
def test_compress_bytes(total_moves):
    data = LIBC[8192:8192 + 2048]
    want = JCM.compress(data, JConfig(chains=8), total_moves=total_moves,
                        use_mesh=False)
    got = TCM.compress(data, TConfig(chains=8), total_moves=total_moves,
                       device="cpu")
    assert got == want
    assert lzma.decompress(got, format=lzma.FORMAT_ALONE) == data


def test_cli_round_trip(tmp_path, capsys):
    src, out, back = (tmp_path / n for n in ("in.bin", "out.lzma",
                                             "back.bin"))
    src.write_bytes(LIBC[20000:20000 + 512])
    assert cli.main(["compress", str(src), "-o", str(out), "--device",
                     "cpu", "--chains", "8", "--moves", "16",
                     "--quiet"]) == 0
    assert cli.main(["decompress", str(out), "-o", str(back)]) == 0
    assert back.read_bytes() == src.read_bytes()
    assert cli.main(["verify", str(src), str(out)]) == 0
    assert capsys.readouterr().out.strip() == "OK"
