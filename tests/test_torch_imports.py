"""The port stands alone: no module of fedml_tpu_torch, and neither
chip_smoke.py nor the tools/torch_*.py scripts, imports JAX or anything of
the JAX package."""

import ast
import pathlib

import jax  # noqa: F401
import torch  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "fedml_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_no_jax_package():
    files = sorted((ROOT / "fedml_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob(
        "torch_*.py"))
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), mod) for f in files
           for mod in _imports(f)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_text_and_resnet_modules_import_with_jax_unimportable():
    """The text transformer, the ResNets, the text loader and the kernel
    Functions import and build their models in a process where ``jax``
    and ``fedml_tpu`` cannot be imported at all."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'fedml_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from fedml_tpu_torch.models import resnet, text_transformer\n"
        "from fedml_tpu_torch.models import model_hub\n"
        "from fedml_tpu_torch.data import data_loader, synthetic\n"
        "from fedml_tpu_torch.ops import attention\n"
        "from fedml_tpu_torch.arguments import load_arguments\n"
        "for name in ('text_transformer', 'resnet18_gn', 'resnet20'):\n"
        "    model_hub.create(load_arguments().update(model=name), 10)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    walked = {str(f.relative_to(ROOT)) for f in
              (ROOT / "fedml_tpu_torch").rglob("*.py")}
    assert {"fedml_tpu_torch/models/text_transformer.py",
            "fedml_tpu_torch/models/resnet.py"} <= walked


def test_zoo_modules_import_with_jax_unimportable():
    """The LSTM, VGG, MobileNet, EfficientNet and GCN models, and the LM,
    tag-prediction and tabular loader branches, run in a process where
    ``jax`` and ``fedml_tpu`` cannot be imported at all."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'fedml_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from fedml_tpu_torch.models import (efficientnet, gcn, mobilenet,\n"
        "                                    model_hub, rnn, vgg)\n"
        "from fedml_tpu_torch.data import data_loader\n"
        "from fedml_tpu_torch.arguments import load_arguments\n"
        "for name in ('rnn', 'rnn_stackoverflow', 'vgg11', 'mobilenet',\n"
        "             'efficientnet', 'gcn'):\n"
        "    model_hub.create(load_arguments().update(model=name), 10)\n"
        "for ds in ('shakespeare', 'stackoverflow_lr', 'uci'):\n"
        "    data_loader.load(load_arguments().update(\n"
        "        dataset=ds, train_size=40, test_size=8, seq_len=8))\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    walked = {str(f.relative_to(ROOT)) for f in
              (ROOT / "fedml_tpu_torch").rglob("*.py")}
    assert {f"fedml_tpu_torch/models/{m}.py" for m in
            ("rnn", "vgg", "mobilenet", "efficientnet", "gcn")} <= walked


def test_engine_modules_import_with_jax_unimportable():
    """FedNAS, FedSeg, FedGKT, FedGAN, split learning, vertical FL,
    TurboAggregate and the centralized trainer, with their models, the
    secagg copy and the segmentation and vertical loaders, import and build
    in a process where ``jax`` and ``fedml_tpu`` cannot be imported at
    all."""
    import subprocess
    import sys

    modules = ("core.mpc.secagg", "models.darts", "models.unet",
               "models.gan", "models.vfl", "simulation.sp.fednas",
               "simulation.sp.fedseg", "simulation.sp.fedgkt",
               "simulation.sp.fedgan", "simulation.sp.split_nn",
               "simulation.sp.vertical_fl", "simulation.sp.turboaggregate",
               "simulation.centralized_trainer", "simulation.simulator")
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'fedml_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module('fedml_tpu_torch.' + m)\n"
        "from fedml_tpu_torch.models import model_hub\n"
        "from fedml_tpu_torch.data import data_loader\n"
        "from fedml_tpu_torch.arguments import load_arguments\n"
        "from fedml_tpu_torch.simulation.sp.turboaggregate import \\\n"
        "    TurboAggregateAPI\n"
        "for name in ('darts', 'darts_search', 'unet', 'unet_small',\n"
        "             'deeplab'):\n"
        "    model_hub.create(load_arguments().update(model=name), 4)\n"
        "for ds in ('fets2021', 'cityscapes'):\n"
        "    data_loader.load(load_arguments().update(\n"
        "        dataset=ds, train_size=8, test_size=4,\n"
        "        input_shape=(8, 8, 3)))\n"
        "data_loader.load_vertical(load_arguments().update(\n"
        "    dataset='nus_wide', train_size=8))\n"
        "TurboAggregateAPI(4, 2).aggregate([np.ones(3)] * 4)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    walked = {str(f.relative_to(ROOT)) for f in
              (ROOT / "fedml_tpu_torch").rglob("*.py")}
    assert {"fedml_tpu_torch/" + m.replace(".", "/") + ".py"
            for m in modules} <= walked


def test_causal_lm_modules_import_without_jax_or_transformers():
    """The trainer, the streaming cross-entropy, MoE, the checkpointer, the
    HF import and the hub's LLM names import and build in a process where
    ``jax``, ``fedml_tpu`` and ``transformers`` cannot be imported at all
    (the card's machine has no ``transformers``: only reading a checkpoint
    path imports it)."""
    import subprocess
    import sys

    modules = ("ops.xent", "llm.moe", "llm.trainer", "llm.hf_import",
               "core.checkpoint", "llm.fedllm", "simulation.sp.fedavg_api")
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'fedml_tpu',\n"
        "          'transformers'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module('fedml_tpu_torch.' + m)\n"
        "from fedml_tpu_torch.models import model_hub\n"
        "from fedml_tpu_torch.arguments import load_arguments\n"
        "for name in ('transformer', 'gpt', 'llama', 'tiny_llama'):\n"
        "    model_hub.create(load_arguments().update(model=name,\n"
        "                                             llm_n_layers=1), 90)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    walked = {str(f.relative_to(ROOT)) for f in
              (ROOT / "fedml_tpu_torch").rglob("*.py")}
    assert {"fedml_tpu_torch/" + m.replace(".", "/") + ".py"
            for m in modules} <= walked


def test_mesh_modules_import_with_jax_unimportable():
    """The mesh engine, its layout, collectives, launcher, the
    hierarchical and ring-gossip engines, the pipeline trainer, the
    pipeline and ring-attention ops, ``pipe_mlp``, the flat model view and
    the quantizer import in a process where ``jax`` and ``fedml_tpu``
    cannot be imported at all, and the quantizer runs there."""
    import subprocess
    import sys

    modules = ("core.mesh", "core.flatmodel", "core.compression.blockscale",
               "simulation.mesh.layout", "simulation.mesh.collectives",
               "simulation.mesh.engine", "simulation.mesh.launch",
               "simulation.mesh.mesh_simulator",
               "simulation.mesh.hierarchical_mesh",
               "simulation.mesh.decentralized_mesh", "simulation.simulator",
               "simulation.mesh.pipeline", "ops.pipeline",
               "ops.ring_attention", "models.pipe_mlp")
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'fedml_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module('fedml_tpu_torch.' + m)\n"
        "from fedml_tpu_torch.core.compression import blockscale\n"
        "blockscale.collective_quantize(torch.ones(300), 'int8',\n"
        "                               torch.Generator())\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    walked = {str(f.relative_to(ROOT)) for f in
              (ROOT / "fedml_tpu_torch").rglob("*.py")}
    assert {"fedml_tpu_torch/" + m.replace(".", "/") + ".py"
            for m in modules} <= walked


def test_mesh2d_and_tp_modules_import_with_jax_unimportable():
    """The 2-D client x model mesh, the layout, the tensor-parallel model,
    expert-parallel MoE and the memory estimators import and build where
    ``jax`` and ``fedml_tpu`` cannot be imported at all."""
    import subprocess
    import sys

    modules = ("core.mesh", "core.memory_estimate", "core.federated",
               "simulation.mesh.layout", "simulation.mesh.engine",
               "simulation.mesh.hierarchical_mesh",
               "simulation.mesh.decentralized_mesh", "llm.model", "llm.moe",
               "llm.convert", "llm.fedllm", "llm.trainer")
    code = (
        "import sys, importlib, types, torch\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'fedml_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module('fedml_tpu_torch.' + m)\n"
        "from fedml_tpu_torch.core.mesh import Mesh\n"
        "from fedml_tpu_torch.llm.model import LlamaLM, TINY\n"
        "from fedml_tpu_torch.simulation.mesh.layout import MeshLayout\n"
        "from fedml_tpu_torch.core import memory_estimate as me\n"
        "with torch.device('meta'):\n"
        "    lm = LlamaLM(TINY, mesh=Mesh(2, 1, 'cpu', model=2))\n"
        "assert lm.tp_dims()\n"
        "assert MeshLayout(Mesh(4, 3, 'cpu', model=2)).param_spec((8, 6))\n"
        "me.estimate_fedllm_memory(me.FedLLMLayout(1e9, 1e6, 8, 4, 2))\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    walked = {str(f.relative_to(ROOT)) for f in
              (ROOT / "fedml_tpu_torch").rglob("*.py")}
    assert {"fedml_tpu_torch/" + m.replace(".", "/") + ".py"
            for m in modules} <= walked


def test_cross_silo_modules_run_with_jax_flax_and_msgpack_unimportable():
    """The message plane (codec, backends, chaos, reliability, chunking),
    the alg frame, the tracer and the cross-silo server and client import
    and run a federation (server and 2 silos as threads, 2 rounds over the
    local backend with chunked frames and reliable delivery, then a codec
    round trip) in a process where ``jax``, ``flax``, ``msgpack``, ``paho``,
    ``grpc`` and ``fedml_tpu`` cannot be imported at all, as on the card's
    machine."""
    import subprocess
    import sys

    modules = ("obs", "obs.tracer", "obs.context",
               "core.distributed.communication.message",
               "core.distributed.communication.base_com_manager",
               "core.distributed.communication.local.local_comm_manager",
               "core.distributed.communication.filestore."
               "filestore_comm_manager",
               "core.distributed.communication.mqtt.mini_mqtt",
               "core.distributed.communication.mqtt.mini_broker",
               "core.distributed.communication.mqtt.mqtt_s3_comm_manager",
               "core.distributed.communication.fault_injection",
               "core.distributed.reliability", "core.distributed.chunking",
               "core.distributed.fedml_comm_manager",
               "core.alg_frame.client_trainer",
               "core.alg_frame.server_aggregator", "core.alg_frame.context",
               "core.alg_frame.params", "cross_silo.message_define",
               "cross_silo.server.fedml_aggregator",
               "cross_silo.server.fedml_server_manager",
               "cross_silo.client.fedml_client_master_manager",
               "cross_silo.client.client_launcher", "runner")
    code = (
        "import sys, importlib, threading\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'paho',\n"
        "          'grpc', 'fedml_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module('fedml_tpu_torch.' + m)\n"
        "import fedml_tpu_torch\n"
        "from fedml_tpu_torch import data, model\n"
        "from fedml_tpu_torch.cross_silo.server import Server\n"
        "from fedml_tpu_torch.cross_silo.client import Client\n"
        "from fedml_tpu_torch.core.distributed.communication import message\n"
        "def args(rank):\n"
        "    return fedml_tpu_torch.load_arguments().update(\n"
        "        training_type='cross_silo', backend='local', rank=rank,\n"
        "        run_id='nojax', dataset='synthetic', num_classes=10,\n"
        "        input_shape=(14, 14, 1), train_size=128, test_size=32,\n"
        "        client_num_in_total=2, client_num_per_round=2,\n"
        "        comm_round=2, batch_size=16, client_id_list=[1, 2],\n"
        "        reliable_delivery=True, reliable_types=[1, 2, 3],\n"
        "        wire_chunk_bytes=1024)\n"
        "out = {}\n"
        "def server():\n"
        "    a = args(0); ds, n = data.load(a)\n"
        "    out['p'] = Server(a, 'cpu', ds, model.create(a, n)).run()\n"
        "def client(r):\n"
        "    a = args(r); ds, n = data.load(a)\n"
        "    Client(a, 'cpu', ds, model.create(a, n)).run()\n"
        "ts = [threading.Thread(target=server, daemon=True)] + [\n"
        "    threading.Thread(target=client, args=(r,), daemon=True)\n"
        "    for r in (1, 2)]\n"
        "[t.start() for t in ts]; [t.join(60) for t in ts]\n"
        "assert not any(t.is_alive() for t in ts)\n"
        "back = message.decode_tree(message.encode_tree(out['p']))\n"
        "assert all(np.array_equal(back[k], v.numpy())\n"
        "           for k, v in out['p'].items())\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    walked = {str(f.relative_to(ROOT)) for f in
              (ROOT / "fedml_tpu_torch").rglob("*.py")}
    assert {"fedml_tpu_torch/" + m.replace(".", "/") + ".py"
            for m in modules if m != "obs"} <= walked


def test_wire_modules_run_with_jax_flax_and_msgpack_unimportable():
    """The wire codec, the wire checkpointer, the two-tier silo drivers
    and the buffered-async driver import and run (a two-tier round with
    the int8 wire, a codec round trip through the message bytes) in a
    process where ``jax``, ``flax``, ``msgpack`` and ``fedml_tpu`` cannot
    be imported at all."""
    import subprocess
    import sys

    modules = ("core.wire", "core.checkpoint", "store.hierarchy",
               "simulation.async_driver", "simulation.simulator")
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'msgpack',\n"
        "          'fedml_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module('fedml_tpu_torch.' + m)\n"
        "import fedml_tpu_torch\n"
        "from fedml_tpu_torch import data, model\n"
        "from fedml_tpu_torch.core import wire\n"
        "from fedml_tpu_torch.core.distributed.communication.message \\\n"
        "    import decode_tree, encode_tree\n"
        "from fedml_tpu_torch.store import HierarchicalSiloAPI\n"
        "a = fedml_tpu_torch.load_arguments().update(\n"
        "    dataset='synthetic', num_classes=4, input_shape=(8,),\n"
        "    train_size=96, test_size=32, client_num_in_total=8,\n"
        "    client_num_per_round=4, batch_size=8, num_silos=2,\n"
        "    wire_precision='int8', wire_block=16)\n"
        "ds, n = data.load(a)\n"
        "api = HierarchicalSiloAPI(a, 'cpu', ds, model.create(a, n))\n"
        "assert np.isfinite(float(api.train_one_round(0)['train_loss']))\n"
        "p, _ = wire.WireCodec('int8', 16, api.layout).encode(\n"
        "    wire.state_tree(api.state))\n"
        "back = wire.WireCodec.decode(decode_tree(encode_tree(p)),\n"
        "                             api.layout)\n"
        "assert list(back['global_params']) == api.order\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    walked = {str(f.relative_to(ROOT)) for f in
              (ROOT / "fedml_tpu_torch").rglob("*.py")}
    assert {"fedml_tpu_torch/" + m.replace(".", "/") + ".py"
            for m in modules} <= walked


def test_trust_stack_and_serving_obs_run_with_jax_unimportable():
    """The attacks, every defense, DP and the serving engine's obs hooks
    import and run in a process where ``jax`` and ``fedml_tpu`` cannot be
    imported at all."""
    import subprocess
    import sys

    modules = ("core.noise", "core.security.fedml_attacker",
               "core.security.fedml_defender",
               "core.security.defense.common",
               "core.security.defense.robust_aggregation",
               "core.security.defense.clipping",
               "core.security.defense.reweighting",
               "core.security.defense.outlier",
               "core.security.defense.soteria_defense",
               "core.security.attack.byzantine_attack",
               "core.security.attack.backdoor_attack",
               "core.security.attack.label_flipping_attack",
               "core.security.attack.lazy_worker_attack",
               "core.security.attack.model_replacement_attack",
               "core.security.attack.gradient_inversion",
               "core.dp.mechanisms", "core.dp.frames",
               "core.dp.budget_accountant",
               "core.dp.fedml_differential_privacy", "serving.batching")
    code = (
        "import importlib, sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'fedml_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module('fedml_tpu_torch.' + m)\n"
        "from fedml_tpu_torch.arguments import load_arguments\n"
        "from fedml_tpu_torch.core.security.defense import (\n"
        "    create_defender, registered_names)\n"
        "from fedml_tpu_torch.core.dp.fedml_differential_privacy import \\\n"
        "    FedMLDifferentialPrivacy\n"
        "g = torch.Generator().manual_seed(0)\n"
        "raw = [(1.0, {'w': torch.randn(3, 2, generator=g)})\n"
        "       for _ in range(6)]\n"
        "for name in registered_names():\n"
        "    d = create_defender(name, load_arguments().update(\n"
        "        defense_type=name))\n"
        "    d.run(raw, extra=raw[0][1])\n"
        "dp = FedMLDifferentialPrivacy()\n"
        "dp.init(load_arguments().update(enable_dp=True,\n"
        "                                dp_solution_type='nbafl'))\n"
        "assert torch.isfinite(dp.add_global_noise(raw[0][1])['w']).all()\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    walked = {str(f.relative_to(ROOT)) for f in
              (ROOT / "fedml_tpu_torch").rglob("*.py")}
    for m in modules:
        path = "fedml_tpu_torch/" + m.replace(".", "/")
        assert {path + ".py", path + "/__init__.py"} & walked, m


def test_trust_stack_second_half_runs_with_jax_unimportable():
    """CKKS and its hooks, the contribution assessors, the field
    arithmetic and the SecAgg and LightSecAgg FSMs import and run in a
    process where ``jax`` and ``fedml_tpu`` cannot be imported at all."""
    import subprocess
    import sys

    modules = ("core.fhe.ckks", "core.fhe.fhe_agg",
               "core.contribution.contribution_assessor_manager",
               "core.contribution.gtg_shapley", "core.contribution.loo",
               "core.contribution.mr_shapley", "core.mpc.secagg",
               "core.mpc.lightsecagg", "cross_silo.secagg",
               "cross_silo.lightsecagg")
    code = (
        "import importlib, sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'fedml_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module('fedml_tpu_torch.' + m)\n"
        "from fedml_tpu_torch.arguments import load_arguments\n"
        "from fedml_tpu_torch.core.fhe.fhe_agg import FedMLFHE\n"
        "from fedml_tpu_torch.core.contribution.contribution_assessor_manager\\\n"
        "    import ContributionAssessorManager\n"
        "from fedml_tpu_torch.core.mpc.lightsecagg import lightsecagg_round\n"
        "fhe = FedMLFHE()\n"
        "fhe.init(load_arguments().update(enable_fhe=True))\n"
        "raw = [(1.0 + i, {'w': torch.full((3, 2), float(i))})\n"
        "       for i in range(3)]\n"
        "out = fhe.fhe_dec('global', fhe.fhe_fedavg(\n"
        "    [(n, fhe.fhe_enc('local', p)) for n, p in raw]))\n"
        "assert torch.allclose(out['w'], torch.full((3, 2), 8 / 6))\n"
        "phi = {}\n"
        "ContributionAssessorManager(load_arguments().update(\n"
        "    enable_contribution=True, contribution_alg='mr')).run(\n"
        "    [0, 1, 2], raw, None, lambda p: -float(p['w'].mean()), phi)\n"
        "assert sorted(phi) == [0, 1, 2]\n"
        "xs = [np.full(4, 0.5, np.float32)] * 3\n"
        "assert np.allclose(lightsecagg_round(xs, 3, 2, 1, [0, 1, 2]), 1.5)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    walked = {str(f.relative_to(ROOT)) for f in
              (ROOT / "fedml_tpu_torch").rglob("*.py")}
    for m in modules:
        path = "fedml_tpu_torch/" + m.replace(".", "/")
        assert {path + ".py", path + "/__init__.py"} & walked, m
