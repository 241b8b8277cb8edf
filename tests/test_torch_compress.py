"""The slice end to end on the CPU: megalania_tpu_torch's compressor
emits the same bytes as megalania_tpu's for the same seed, and the
ported CLI round-trips a file."""
import lzma
import os

import pytest

from megalania_tpu import compressor as JCM
from megalania_tpu.anneal.config import AnnealConfig as JConfig
from megalania_tpu_torch import cli, compressor as TCM
from megalania_tpu_torch.anneal import engine
from megalania_tpu_torch.anneal.config import AnnealConfig as TConfig
from megalania_tpu_torch.models import packets as P
from megalania_tpu_torch.runtime import emit

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


@pytest.mark.parametrize("init", ["literal", "greedy", "mixed", "optimal",
                                  "mixed_opt"])
def test_dp_only_stream_is_the_contexts_seed(init):
    """The DP-only mode and make_context take a block's initial parse
    from one function: the stream of total_moves=0 is the emission of the
    context's init_slab, under every init."""
    data = LIBC[8192:8192 + 1024]
    cfg = TConfig(chains=8, init=init)
    got = TCM.compress_block(data, cfg, total_moves=0, device="cpu").stream
    seed = P.to_u32(engine.make_context(data, cfg, "cpu").init_slab)
    assert got == emit.emit(data, seed, dict_size=cfg.dict_size, lc=cfg.lc)


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
