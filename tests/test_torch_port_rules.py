"""Rules of the PyTorch port: it imports nothing of JAX or of the JAX
package, keeps identical presets, runs on the card unless asked otherwise,
and its kernel wrappers launch nothing for CPU tensors."""

import ast
import dataclasses
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import bpx.config as jconfig
import bpx.models as jmodels
import bpx_torch
import bpx_torch.config as tconfig
from bpx_torch.ops.flash_attention import flash_attention
from bpx_torch.ops.norm import layer_norm

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "sklearn", "bpx")
# packages the card's machine lacks: none may be imported when a module of
# the port is (h5py only inside the function that reads mmimdb's hdf5)
ABSENT_ON_THE_CARD = ("jax", "jaxlib", "flax", "optax", "orbax", "sklearn",
                      "h5py", "safetensors", "bpx")


def _port_files():
    return (sorted((ROOT / "bpx_torch").rglob("*.py"))
            + sorted((ROOT / "scripts").glob("torch_*.py"))
            + [ROOT / "chip_smoke.py"])


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_bpx_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def _module_level_imports(tree):
    """Import nodes outside any function body."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            yield node
        stack.extend(ast.iter_child_nodes(node))


def test_training_loop_packages_are_covered():
    parts = {p.relative_to(ROOT).parts[:2] for p in _port_files()}
    for sub in ("data", "utils", "cli", "train"):
        assert ("bpx_torch", sub) in parts, sub


def test_multiseed_and_cluster_are_covered():
    files = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert {"bpx_torch/train/multiseed.py", "bpx_torch/cluster/__init__.py",
            "bpx_torch/cluster/scheduler.py"} <= files


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_level_h5py(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = [a.name for node in _module_level_imports(tree)
             if isinstance(node, ast.Import) for a in node.names]
    names += [node.module or "" for node in _module_level_imports(tree)
              if isinstance(node, ast.ImportFrom)]
    assert not [n for n in names if n == "h5py" or n.startswith("h5py.")]


def test_every_module_imports_without_the_missing_packages():
    modules = [m.name for m in pkgutil.walk_packages(bpx_torch.__path__,
                                                     "bpx_torch.")]
    code = ("import sys\n"
            f"for name in {ABSENT_ON_THE_CARD!r}:\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    for name in ("bpx_torch.data.loaders", "bpx_torch.train.loop",
                 "bpx_torch.cli.train", "bpx_torch.utils.checkpoint"):
        assert name in modules


def test_trainer_entry_points_default_to_cuda(monkeypatch, tmp_path):
    from bpx_torch.serve import Predictor
    from bpx_torch.train import loop
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    exp = tconfig.get_preset("synthetic-tiny")
    exp = exp.replace(train=dataclasses.replace(exp.train,
                                                savedir=str(tmp_path)))
    for fn in (loop.train, loop.test, loop.seed_sweep):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(exp)
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor.from_checkpoint(exp, str(tmp_path))
    assert not list(tmp_path.iterdir())     # raised before writing anything


def test_every_module_imports_without_jax():
    modules = [m.name for m in pkgutil.walk_packages(bpx_torch.__path__,
                                                     "bpx_torch.")]
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'flax', 'bpx'):\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "print(len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(modules) >= 15


@pytest.mark.parametrize("name", sorted(jconfig.PRESETS))
def test_presets_match_the_jax_package(name):
    want = dataclasses.asdict(jconfig.get_preset(name))
    got = dataclasses.asdict(tconfig.get_preset(name))
    assert got == want
    # a config.json snapshot of either package loads in the other
    snap = json.loads(json.dumps(want))
    assert tconfig.config_from_dict(snap) == tconfig.get_preset(name)
    assert jconfig.config_from_dict(json.loads(json.dumps(got))) == \
        jconfig.get_preset(name)


def test_entry_points_default_to_cuda(monkeypatch):
    from bpx_torch.models import get_model
    from bpx_torch.serve import Predictor
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    exp = tconfig.get_preset("synthetic-tiny")
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(exp)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model(exp.model)
    assert Predictor(exp, device="cpu").device.type == "cpu"


def test_unported_models_and_options_raise():
    """Every registry name builds; the notebook-era models take ``hybrid``
    and ``fusion="mag"`` and ignore them, as the JAX package's do (the same
    parameters as without); ``hybrid`` and ``group_encoders`` are ported on
    BPMulT and refuse only what the JAX package refuses."""
    from bpx_torch.models import MODELS, get_model
    m = tconfig.get_preset("synthetic-tiny").model
    assert sorted(MODELS) == sorted(jmodels.MODELS)
    vat = tconfig.get_preset("iemocap").model
    for name in MODELS:
        get_model((vat if name == "mmtrvat" else m).replace(model=name),
                  device="meta")
    names = lambda model: [n for n, _ in model.named_parameters()]
    plain = names(get_model(m.replace(model="mmtrvpa"), device="meta"))
    for option in (dict(hybrid=True), dict(fusion="mag")):
        assert names(get_model(m.replace(model="mmtrvpa", **option),
                               device="cpu")) == plain
    for cfg in (m, vat):
        get_model(cfg.replace(group_encoders=True, hybrid=True),
                  device="meta")
        with pytest.raises(ValueError, match="attn_dropout_a"):
            get_model(cfg.replace(group_encoders=True, attn_dropout_a=0.1,
                                  attn_dropout_v=0.0), device="meta")
    with pytest.raises(ValueError, match="hybrid"):
        get_model(vat.replace(hybrid=True, fusion="mag"), device="meta")


def test_cpu_tensors_launch_no_kernel():
    flash_attention.launches = 0
    layer_norm.launches = 0
    q = torch.randn(2, 2, 8, 64)
    flash_attention(q, q, q, masked=True)
    flash_attention(q, q, q, masked=False,
                    kv_lens=torch.tensor([8, 3], dtype=torch.int32))
    layer_norm(torch.randn(4, 16), torch.ones(16), torch.zeros(16), 1e-6)
    # a whole served forward on the CPU
    from bpx_torch.serve import Predictor
    exp = tconfig.get_preset("synthetic-tiny")
    m, d = exp.model, exp.data
    batch = {
        "txt": torch.randint(1, 100, (2, m.num_vectors_l)).numpy(),
        "mask": torch.ones(2, m.num_vectors_l, dtype=torch.int32).numpy(),
        "segment": torch.zeros(2, m.num_vectors_l,
                               dtype=torch.int32).numpy(),
        "video": torch.rand(2, d.video_len, m.orig_d_v).numpy(),
        "audio": torch.rand(2, d.audio_raw_len, m.orig_d_a).numpy(),
        "poster": torch.rand(2, m.orig_d_p).numpy(),
    }
    probs = Predictor(exp, batch_size=4, device="cpu")(batch)
    assert probs.shape == (2, m.n_classes)
    assert flash_attention.launches == 0
    assert layer_norm.launches == 0


def test_other_devices_raise():
    q = torch.empty(1, 1, 4, 64, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        flash_attention(q, q, q)
    with pytest.raises(RuntimeError, match="no kernel"):
        layer_norm(torch.empty(4, 8, device="meta"),
                   torch.empty(8, device="meta"),
                   torch.empty(8, device="meta"), 1e-6)


def _global_kernels():
    """Names of the ``__global__`` functions in the port's CUDA sources."""
    import re
    launch_bounds = r"(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?"
    pattern = re.compile(r"__global__\s+void\s+" + launch_bounds
                         + r"(\w+)\s*\(")
    return {m.group(1) for src in (ROOT / "bpx_torch" / "csrc").glob("*.cu")
            for m in pattern.finditer(src.read_text())}


@pytest.mark.parametrize("groups", [1, 2])
def test_profiler_names_are_kernels_of_the_sources(groups):
    """Every kernel name ``chip_smoke.py`` looks for in the profiler (the
    forward's and the backward's at each head dim the wrappers take, for
    one seed group and for several) is a ``__global__`` of
    ``bpx_torch/csrc``, so a renamed kernel cannot leave the card's checks
    looking for a name nothing launches."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from bpx_torch.ops.flash_attention import KERNEL_ALIGN
    kernels = _global_kernels()
    assert {"flash_fwd_kernel", "flash_fwd_tall_kernel",
            "flash_delta_kernel"} <= kernels
    for d in KERNEL_ALIGN:
        names = [chip_smoke.fwd_kernel(d, groups)]
        names += chip_smoke.kernel_names(chip_smoke.bwd_kernels(d, groups))
        for name in names:
            assert name.split("<")[0] in kernels, (d, name)
