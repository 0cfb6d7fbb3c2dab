"""The port stands alone: it imports torch and numpy, never JAX and nothing
of the JAX package, imports without CUDA, and refuses to run on the CPU
unless asked to."""

import ast
import importlib
import pathlib
import pkgutil

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "liorf_tpu_torch"
FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "liorf_tpu", "flax", "optax")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [(name, line) for name, line in _imported_roots(path) if name in FORBIDDEN]
    assert not bad, f"{path}: forbidden imports {bad}"
    # dynamic imports would dodge the AST walk
    text = path.read_text()
    assert "import_module(\"jax" not in text and "__import__(\"jax" not in text


def test_every_module_imports_without_cuda():
    import liorf_tpu_torch

    names = [m.name for m in pkgutil.walk_packages(liorf_tpu_torch.__path__, "liorf_tpu_torch.")]
    assert len(names) > 25
    for name in names:
        importlib.import_module(name)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_pipeline_exports():
    from liorf_tpu_torch import pipeline

    assert {
        "SlamConfig", "load_config", "LiorfPipeline", "ResidentPipeline", "make_pipeline"
    } <= set(dir(pipeline))


def test_dist_exports():
    from liorf_tpu_torch import dist

    assert {
        "make_mesh", "ShardedResidentPipeline", "GraphMesh", "solve_shard_map", "solve_sharded",
        "shard_graph", "scan_to_map_sharded", "detect_loop_sharded",
    } <= set(dir(dist))
    for name in ("sharded", "shard_map_solver", "sharded_frontend", "resident_sharded",
                 "multihost", "launch", "cases"):
        assert (PKG / "dist" / f"{name}.py").exists(), name


def test_dist_entry_points_default_to_cuda(tmp_path):
    """The distributed entry points follow the pipeline's device rule too:
    no device named means the GPU, and raises here where there is none."""
    import datetime

    import torch.distributed as tdist

    from liorf_tpu_torch import cli
    from liorf_tpu_torch.dist import make_mesh
    from liorf_tpu_torch.dist.multihost import init_multihost

    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only behaviour")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_multihost(f"file://{tmp_path}/rdv", 1, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["optimize", "--checkpoint", str(tmp_path / "none.pkl")])
    assert not tdist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(device="cpu")
    tdist.init_process_group("gloo", store=tdist.HashStore(), rank=0, world_size=1,
                             timeout=datetime.timedelta(seconds=30))
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
        with pytest.raises(ValueError, match="2 devices"):
            make_mesh(2, device="cpu")
        assert make_mesh(1, device="cpu").device.type == "cpu"
    finally:
        tdist.destroy_process_group()


def test_default_device_is_cuda_and_raises_without_one():
    from liorf_tpu_torch.pipeline import LiorfPipeline, SlamConfig

    cfg = SlamConfig(scan_capacity=256, map_capacity=1024, kf_cloud_capacity=256)
    if torch.cuda.is_available():
        assert LiorfPipeline(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            LiorfPipeline(cfg)
    assert LiorfPipeline(cfg, device="cpu").device.type == "cpu"


def _state_constructors():
    import numpy as np

    from liorf_tpu_torch import convert
    from liorf_tpu_torch.core.pointcloud import make_cloud
    from liorf_tpu_torch.graph.pose_graph import empty_graph
    from liorf_tpu_torch.mapping.keyframes import KeyframeStore
    from liorf_tpu_torch.pipeline import SlamConfig, make_pipeline
    from liorf_tpu_torch.pipeline.multistream import MultiStreamPipeline

    z3 = np.zeros((4, 3), np.float32)
    grid = dict(xyz=z3, keys=np.zeros(4, np.int32), mask=np.ones(4, bool),
                origin=np.zeros(3, np.float32), cell_size=np.float32(1.0))
    return {
        "KeyframeStore": lambda **kw: KeyframeStore(cloud_capacity=8, initial_kf_capacity=2, **kw).device,
        "empty_graph": lambda **kw: empty_graph(2, 2, 1, **kw).Rs.device,
        "make_cloud": lambda **kw: make_cloud(z3, **kw).xyz.device,
        "convert.grid_from_arrays": lambda **kw: convert.grid_from_arrays(grid, **kw).xyz.device,
        "convert.keyframe_store_from_arrays": lambda **kw: convert.keyframe_store_from_arrays(
            dict(poses=np.zeros((2, 6)), times=np.zeros(2), clouds=np.zeros((2, 8, 3)),
                 cloud_masks=np.zeros((2, 8), bool), sc_descs=np.zeros((2, 20, 60)),
                 sc_keys=np.zeros((2, 20))), 0, **kw).device,
        "make_pipeline": lambda **kw: make_pipeline(
            SlamConfig(scan_capacity=256, map_capacity=1024, kf_cloud_capacity=256), **kw
        ).device,
        "convert.resident_state_from_arrays": lambda **kw: convert.resident_state_from_arrays(
            _resident_fields(), **kw).kf_poses.device,
        "MultiStreamPipeline": lambda **kw: MultiStreamPipeline(
            SlamConfig(scan_capacity=256, map_capacity=1024, kf_cloud_capacity=256), 2, **kw
        ).device,
    }


def _resident_fields():
    """A ResidentState's fields as numpy (a one-slot state, all zeros)."""
    import numpy as np

    from liorf_tpu_torch.pipeline.resident import ResidentState

    fields = {name: np.zeros(1, np.float32) for name in ResidentState._fields}
    fields["filt"] = dict(mean={k: np.zeros(3, np.float32) for k in ("R", "p", "v", "ba", "bg")},
                          sqrt_info=np.eye(15, dtype=np.float32))
    fields["grid"] = dict(xyz=np.zeros((4, 3), np.float32), keys=np.zeros(4, np.int32),
                          mask=np.ones(4, bool), origin=np.zeros(3, np.float32),
                          cell_size=np.float32(1.0))
    return fields


@pytest.mark.parametrize(
    "name",
    ["KeyframeStore", "empty_graph", "make_cloud", "convert.grid_from_arrays",
     "convert.keyframe_store_from_arrays", "make_pipeline",
     "convert.resident_state_from_arrays", "MultiStreamPipeline"],
)
def test_state_constructors_default_to_cuda(name):
    """Every constructor of device state follows the pipeline's rule: no
    device named means the GPU, and raises here where there is none, so that
    nothing (loop verification on a hand-built store, say) runs on the CPU
    unasked."""
    make = _state_constructors()[name]
    if torch.cuda.is_available():
        assert make().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert make(device="cpu").type == "cpu"


def test_slice_four_modules_are_in_the_port():
    """The modules this slice adds exist in the port and import without
    CUDA (the AST walk above holds them to torch and numpy)."""
    for name in ("liorf_tpu_torch/pipeline/multistream.py", "liorf_tpu_torch/native/__init__.py",
                 "liorf_tpu_torch/native/src/liorf_native.cpp",
                 "liorf_tpu_torch/sensors/kitti.py", "liorf_tpu_torch/sensors/mulran.py",
                 "liorf_tpu_torch/sensors/rosbag.py"):
        assert (ROOT / name).exists(), name
    from liorf_tpu_torch import cli

    with pytest.raises(SystemExit):  # argparse refuses a dataset it does not offer
        cli.main(["run", "--dataset", "nope", "--out", "x"])


def test_slice_six_modules_are_in_the_port():
    """The modules slice 6 adds exist in the port and are in the AST walk
    above, which holds them to torch and numpy."""
    for name in ("liorf_tpu_torch/mapping/viz.py", "liorf_tpu_torch/ops/segment_sum.py",
                 "liorf_tpu_torch/csrc/segment_sum.cu"):
        assert (ROOT / name).exists(), name
    walked = {str(p.relative_to(ROOT)) for p in FILES}
    assert {"liorf_tpu_torch/mapping/viz.py", "liorf_tpu_torch/ops/segment_sum.py"} <= walked


def test_checkpoint_name_map_holds_only_strings():
    """The map that reads the JAX package's checkpoints names classes as
    strings: resolving every entry imports the port's class of the same
    module path and name, and never the JAX package (checked in a fresh
    interpreter, where nothing else has imported it)."""
    import subprocess
    import sys

    from liorf_tpu_torch.mapping import export

    assert export.JAX_CLASS_MAP
    for jax_name, port_name in export.JAX_CLASS_MAP.items():
        assert isinstance(jax_name, str) and isinstance(port_name, str)
        assert jax_name.startswith("liorf_tpu.") and port_name.startswith("liorf_tpu_torch.")
        assert jax_name[len("liorf_tpu."):] == port_name[len("liorf_tpu_torch."):]
    code = (
        "import io, sys\n"
        "from liorf_tpu_torch.mapping import export\n"
        "for name, port in export.JAX_CLASS_MAP.items():\n"
        "    cls = export._ArraysOnly(io.BytesIO(b'')).find_class(*name.rsplit('.', 1))\n"
        "    assert f'{cls.__module__}.{cls.__qualname__}' == port, (name, cls)\n"
        "bad = [m for m in sys.modules if m == 'liorf_tpu' or m.startswith('liorf_tpu.')\n"
        "       or m.split('.')[0] in ('jax', 'jaxlib')]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def test_make_cloud_keeps_a_tensors_device():
    from liorf_tpu_torch.core.pointcloud import make_cloud

    assert make_cloud(torch.zeros((4, 3))).xyz.device.type == "cpu"


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """The wrappers dispatch on the tensor's device only: a CUDA tensor goes
    to the kernel (or raises), never to the plain version. Checked here
    without a card by faking the device type of the argument."""
    from liorf_tpu_torch.ops import knn, knn_cuda

    class FakeDev:
        type = "cuda"

    class FakeCudaTensor:
        device = FakeDev()
        shape = (4, 3)

    called = []
    monkeypatch.setattr(knn_cuda, "knn_bruteforce_plain", lambda *a, **k: called.append(1))
    monkeypatch.setattr(knn_cuda, "topk_candidates_plain", lambda *a, **k: called.append(1))
    monkeypatch.setattr(knn_cuda, "knn_grid_topk_plain", lambda *a, **k: called.append(1))
    idx = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(Exception):
        knn_cuda.topk_candidates(FakeCudaTensor(), torch.zeros((4, 8, 3)), idx, k=2)
    grid = knn.build_grid(torch.zeros((4, 3)), torch.ones(4, dtype=torch.bool), torch.zeros(3), 1.0)
    with pytest.raises(Exception):
        knn_cuda.knn_grid_topk(grid, FakeCudaTensor(), torch.ones(4, dtype=torch.bool), k=2)
    with pytest.raises(Exception):
        knn_cuda.knn_bruteforce(
            torch.zeros((4, 3)), torch.ones(4, dtype=torch.bool), FakeCudaTensor(),
            torch.ones(4, dtype=torch.bool), k=1,
        )
    assert not called


def test_config_yaml_shared_with_jax_package():
    from liorf_tpu.pipeline.config import load_config as jload
    from liorf_tpu_torch.pipeline.config import load_config as tload

    paths = sorted((ROOT / "configs").glob("*.yaml"))
    assert paths
    for p in paths:
        a, b = jload(str(p)), tload(str(p))
        da, db = vars(a), vars(b)
        da.pop("savePCDDirectory"), db.pop("savePCDDirectory")
        assert da == db
