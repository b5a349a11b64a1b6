"""The kernel build's cache key (kernels/build.py::library_path) on the CPU:
a library's file name carries a digest of its source and of the headers of
csrc/ the source includes, so that an edited shared header rebuilds every
source that includes it and no other. Nothing is compiled here."""

import shutil

from ltx_tpu_torch.kernels import build


def test_library_path_covers_the_shared_header(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    names = ("flash_attention_fwd", "flash_attention_bwd", "int4_matmul", "rms_norm")
    before = {name: build.library_path(name) for name in names}
    assert [p.name for p in build._sources(csrc / "flash_attention_bwd.cu")] == [
        "flash_attention_bwd.cu", "hopper.cuh"]
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// an edit\n")
    after = {name: build.library_path(name) for name in names}
    assert after["flash_attention_fwd"] != before["flash_attention_fwd"]
    assert after["flash_attention_bwd"] != before["flash_attention_bwd"]
    assert after["int4_matmul"] == before["int4_matmul"]
    assert after["rms_norm"] == before["rms_norm"]
    # the digest is the content's: the same files give the same names
    assert {name: build.library_path(name) for name in names} == after
