"""The installed port: ``pip wheel`` of the tree ships every module of both
packages, the assets the port reads by path, the CUDA sources and the
``pocket-tts-tpu-torch`` command, and the port runs from the unpacked wheel
with nothing of the tree on its path.  Its kernels build under the user's
cache from an install and under ``build/`` from a checkout.

The wheel is built offline from a copy of the tree, as on a machine with no
network: ``pip wheel --no-deps --no-build-isolation --no-index``."""

import dataclasses
import os
import subprocess
import sys
import zipfile
from pathlib import Path

import pytest

from chip_smoke import copy_wheel_sources
from tests.test_torch_host import _yaml_lines, run_no_jax
from tests.test_tts import CFG

ROOT = Path(__file__).resolve().parent.parent
PORT_ASSETS = ("pocket_tts_tpu/assets/tokenizer.json", "pocket_tts_tpu/assets/b6369a24.yaml",
               "pocket_tts_tpu/server/webui.html")


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    """(the wheel, the directory it is unpacked into, a working directory)."""
    tmp = tmp_path_factory.mktemp("install")
    src = tmp / "src"
    copy_wheel_sources(src)  # what chip_smoke.py's phase 13 builds its wheel from
    res = subprocess.run([sys.executable, "-m", "pip", "wheel", str(src), "--no-deps",
                          "--no-build-isolation", "--no-index", "--disable-pip-version-check",
                          "-q", "-w", str(tmp / "dist")],
                         cwd=tmp, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    (whl,) = (tmp / "dist").glob("*.whl")
    site = tmp / "site"
    with zipfile.ZipFile(whl) as z:
        z.extractall(site)
    work = tmp / "work"
    work.mkdir()
    return whl, site, work


def _env(site: Path, work: Path, **extra) -> dict:
    """This environment with the unpacked wheel as the whole PYTHONPATH and
    the user's cache inside ``work``."""
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XDG_CACHE_HOME")}
    return {**env, "PYTHONPATH": str(site), "XDG_CACHE_HOME": str(work / "cache"), **extra}


def _run(code: str, site: Path, work: Path, *args: str, **extra) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code, str(site), *args], cwd=work,
                          env=_env(site, work, **extra), capture_output=True, text=True,
                          timeout=120)


def test_wheel_ships_every_module_asset_kernel_source_and_command(wheel):
    whl, _, _ = wheel
    with zipfile.ZipFile(whl) as z:
        names = set(z.namelist())
        (ep,) = [n for n in names if n.endswith(".dist-info/entry_points.txt")]
        scripts = z.read(ep).decode()
    want = {p.relative_to(ROOT).as_posix()
            for pattern in ("pocket_tts_tpu_torch/**/*.py", "pocket_tts_tpu_torch/csrc/*.cu",
                            "pocket_tts_tpu/**/*.py")
            for p in ROOT.glob(pattern) if "__pycache__" not in p.parts}
    want |= set(PORT_ASSETS)
    assert "pocket_tts_tpu_torch/parallel/mesh.py" in want
    assert "pocket_tts_tpu_torch/csrc/flow_blocks.cu" in want
    assert sorted(want - names) == []
    tops = {n.split("/")[0] for n in names}
    assert {t for t in tops if not t.endswith(".dist-info")} == {"pocket_tts_tpu",
                                                                 "pocket_tts_tpu_torch"}
    lines = [line.replace(" ", "") for line in scripts.splitlines()]
    assert "pocket-tts-tpu-torch=pocket_tts_tpu_torch.cli:main" in lines
    assert "pocket-tts-tpu=pocket_tts_tpu.cli:main" in lines


def test_port_runs_from_the_wheel_without_jax_tokenizers_yaml_safetensors(wheel):
    """test_torch_host's no-JAX script (generate, voice, fine-tuning, the mesh,
    ``shard_batch``) against the unpacked wheel, outside the tree."""
    _, site, work = wheel
    env = _env(site, work)
    res = run_no_jax(work, env)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("OK")
    where = subprocess.run([sys.executable, "-c", "import pocket_tts_tpu_torch as p; "
                            "print(p.__file__)"], cwd=work, env=env, capture_output=True,
                           text=True, timeout=120)
    assert Path(where.stdout.strip()).is_relative_to(site), where.stdout + where.stderr


_ENTRY_POINT = r"""
import sys
from importlib.metadata import distributions
from pathlib import Path
site = sys.argv[1]
eps = {ep.name: ep for d in distributions(path=[site]) for ep in d.entry_points
       if ep.group == "console_scripts"}
ep = eps["pocket-tts-tpu-torch"]
assert ep.value == "pocket_tts_tpu_torch.cli:main", ep.value
main = ep.load()
assert Path(sys.modules["pocket_tts_tpu_torch"].__file__).is_relative_to(site)
try:
    main(["--help"])
    raise AssertionError("--help returned")
except SystemExit as e:
    assert e.code == 0, e.code
try:
    main(["generate", "--text", "Hi there.", "-o", "refused.wav"])
    raise AssertionError("generate ran with no card and no --device cpu")
except RuntimeError as e:
    assert "--device cpu" in str(e), e
import os
assert not os.path.exists("refused.wav")
import numpy as np
import torch
from pocket_tts_tpu_torch import audio
torch.backends.cudnn.allow_tf32 = True
rc = main(["generate", "--variant", "tiny", "--device", "cpu", "--temperature", "0",
           "--eos-threshold", "inf", "--text", "Hi there.", "-o", "cli.wav", "--quiet"])
wav, sr = audio.read_wav("cli.wav")
assert rc == 0 and sr == 24000 and wav.size and wav.size % 1920 == 0, (rc, sr, wav.size)
assert np.isfinite(wav).all() and float(np.abs(wav).max()) > 0
assert not torch.backends.cudnn.allow_tf32  # the codec's convolutions in full float32
print("OK", wav.size)
"""


def test_console_entry_point_from_the_wheel(wheel):
    """``pocket-tts-tpu-torch`` loaded through the unpacked dist-info's
    metadata: ``--help`` exits 0, ``generate`` with no card raises naming
    ``--device cpu``, and with ``--device cpu`` writes a WAV (a tiny YAML
    variant in ./config/) and turns cuDNN's TF32 off."""
    _, site, work = wheel
    (work / "config").mkdir(exist_ok=True)
    (work / "config" / "tiny.yaml").write_text("\n".join(_yaml_lines(dataclasses.asdict(CFG)))
                                              + "\n")
    res = _run(_ENTRY_POINT, site, work, CUDA_VISIBLE_DEVICES="")
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    help_text, last = res.stdout.rsplit("\n", 2)[:2]
    assert help_text.startswith("usage: pocket_tts_tpu_torch") and last.startswith("OK")


def test_kernels_build_under_build_from_the_tree():
    from pocket_tts_tpu_torch.kernels import build

    assert build.PKG == ROOT / "pocket_tts_tpu_torch"
    assert build.BUILD_DIR == ROOT / "build" / "pocket_tts_tpu_torch"


_BUILD_DIR = r"""
import sys
from pathlib import Path
from pocket_tts_tpu_torch.kernels import build, flow_blocks
site, want = sys.argv[1], Path(sys.argv[2])
assert build.PKG == Path(site).resolve() / "pocket_tts_tpu_torch", build.PKG
assert flow_blocks.SOURCE.is_file() and flow_blocks.SOURCE.is_relative_to(build.PKG)
assert build.BUILD_DIR == want, (build.BUILD_DIR, want)
if sys.argv[3] == "unmakeable":
    try:
        build.build(flow_blocks.SOURCE, "flow_blocks")
        raise AssertionError("built under a file")
    except RuntimeError as e:
        assert str(want) in str(e), e
print("OK")
"""


@pytest.mark.parametrize("case", ["xdg", "home", "unmakeable"])
def test_kernels_build_under_the_user_cache_from_the_wheel(wheel, case):
    """From an install: ``$XDG_CACHE_HOME/pocket_tts_tpu_torch/kernels``, or
    ``~/.cache/...`` with XDG_CACHE_HOME unset; a directory that cannot be
    made raises with its path (no nvcc is reached)."""
    _, site, work = wheel
    home = work / f"home_{case}"
    extra = {"HOME": str(home)}
    if case == "xdg":
        want = work / "cache" / "pocket_tts_tpu_torch" / "kernels"
    elif case == "home":
        extra["XDG_CACHE_HOME"] = ""
        want = home / ".cache" / "pocket_tts_tpu_torch" / "kernels"
    else:
        blocker = work / "a_file"
        blocker.write_text("not a directory")
        extra["XDG_CACHE_HOME"] = str(blocker)
        want = blocker / "pocket_tts_tpu_torch" / "kernels"
    res = _run(_BUILD_DIR, site, work, str(want), case, **extra)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("OK")
