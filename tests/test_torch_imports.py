"""The port stands alone: no JAX and nothing of bonito_tpu in the
package or in chip_smoke.py, none of the packages a CUDA host may lack
(pyarrow, zstandard, flatbuffers, tqdm; h5py only inside the fast5
reader's functions), and no silent fallback to the CPU or to a plain
version when the card or its compiler is missing."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "bonito_tpu", "pyarrow", "zstandard",
             "flatbuffers", "tqdm"}
PORT = ROOT / "bonito_tpu_torch"
# the package's sources; build/ holds kernel build output, not source
PORT_FILES = sorted(p for p in PORT.rglob("*.py")
                    if p.relative_to(PORT).parts[0] != "build") + [
    ROOT / "chip_smoke.py"]


def _top_level_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_bonito_tpu_import(path):
    assert not set(_top_level_imports(path)) & FORBIDDEN


def test_h5py_only_inside_the_fast5_reader():
    """h5py is imported inside fast5.py's functions and nowhere else, so
    the port imports (and reads pod5) on a machine without it."""
    for path in PORT_FILES:
        tree = ast.parse(path.read_text(), filename=str(path))
        at_top = {a.name.split(".")[0] for node in tree.body
                  if isinstance(node, ast.Import) for a in node.names} | {
            node.module.split(".")[0] for node in tree.body
            if isinstance(node, ast.ImportFrom) and node.module}
        assert "h5py" not in at_top, path
        if path.name != "fast5.py":
            assert "h5py" not in set(_top_level_imports(path)), path
    assert "h5py" in set(_top_level_imports(PORT / "fast5.py"))


def test_importing_the_port_loads_no_jax():
    """Every module of the port imports in a fresh interpreter, with no
    JAX and without building a kernel (this machine has no nvcc: a build
    at import would raise)."""
    modules = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                     for p in PORT_FILES if p.parent != ROOT
                     and p.name != "__init__.py")
    assert {"bonito_tpu_torch.ops.lstm_fused_cuda",
            "bonito_tpu_torch.ops.decode_fused_cuda",
            "bonito_tpu_torch.ops.attention_cuda",
            "bonito_tpu_torch.ops.attention",
            "bonito_tpu_torch.ops.relayout",
            "bonito_tpu_torch.ops.decode_full_cuda",
            "bonito_tpu_torch.ops.beam_device",
            "bonito_tpu_torch.ops.logz_cuda",
            "bonito_tpu_torch.ops.lattice_cuda",
            "bonito_tpu_torch.transformer.model",
            "bonito_tpu_torch.ops.lstm_train_cuda",
            "bonito_tpu_torch.training", "bonito_tpu_torch.schedule",
            "bonito_tpu_torch.data", "bonito_tpu_torch.io",
            "bonito_tpu_torch.native", "bonito_tpu_torch.alignment",
            "bonito_tpu_torch.cli.train",
            "bonito_tpu_torch.cli.basecaller", "bonito_tpu_torch.arrow",
            "bonito_tpu_torch.pod5", "bonito_tpu_torch.fast5",
            "bonito_tpu_torch.reader", "bonito_tpu_torch.signal",
            "bonito_tpu_torch.bam", "bonito_tpu_torch.aligner",
            "bonito_tpu_torch.__main__"} <= set(modules)
    code = (f"import sys, {', '.join(modules)}; "
            "from bonito_tpu_torch.ops import build; "
            "assert build._lib is None, 'a kernel was built at import'; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'bonito_tpu', 'pyarrow', 'zstandard', "
            "'flatbuffers', 'h5py')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_reader_processes_import_no_torch():
    """What a spawned reader process imports (the pod5 and fast5 readers
    and the pipeline's worker loop) loads no torch: its import took each
    worker seconds on an H100 host."""
    code = ("import sys, bonito_tpu_torch.pod5, bonito_tpu_torch.fast5, "
            "bonito_tpu_torch.pipeline; "
            "sys.exit('torch' in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_need_the_card(monkeypatch, tmp_path):
    from bonito_tpu_torch import resolve_device
    from bonito_tpu_torch.util import load_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model(tmp_path)
    assert resolve_device("cpu") == torch.device("cpu")


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    from bonito_tpu_torch.ops import build
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.library()


def test_failed_native_build_raises(monkeypatch, tmp_path):
    """The accuracy metric's aligner is built with g++ at first use; a
    source that does not compile raises (no numpy fallback)."""
    from bonito_tpu_torch import native
    (tmp_path / "align").mkdir()
    (tmp_path / "align" / "align.cpp").write_text("not C++\n")
    monkeypatch.setattr(native, "NATIVE", tmp_path)
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    monkeypatch.setattr(native, "_loaded", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.load("align")


@pytest.mark.parametrize("name,source", [("vbz", "vbz/vbz.cpp"),
                                         ("mapper", "mapper/mapper.cpp")])
def test_failed_reader_and_mapper_build_raises(monkeypatch, tmp_path, name,
                                               source):
    """The basecaller's svb16 codec and mapper build at first use too; a
    source that does not compile raises, and so do the reader's VBZ and
    the aligner that load them."""
    from bonito_tpu_torch import aligner, native, pod5
    (tmp_path / source).parent.mkdir()
    (tmp_path / source).write_text("not C++\n")
    monkeypatch.setattr(native, "NATIVE", tmp_path)
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    monkeypatch.setattr(native, "_loaded", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.load(name)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        if name == "vbz":
            pod5.vbz_compress(np.zeros(4, np.int16))
        else:
            (tmp_path / "ref.fasta").write_text(">c\nACGT\n")
            aligner.Aligner(str(tmp_path / "ref.fasta"))
