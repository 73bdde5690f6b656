"""The plain reference against the port at a tiny size on the CPU, where
the port runs its plain versions."""
import json

import numpy as np
import pytest
import torch

from benchmark import harness, train
from benchmark.programs import dlrm as prog
from benchmark.reference import dlrm as ref
from benchmark.tests import tinycell
from benchmark.traffic import generator
from benchmark.weights import draw


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tinycell.make(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell_name", [tinycell.TRAIN, tinycell.SERVE])
def test_forward_matches_the_port(root, cell_name):
    cell = harness.load_cell(cell_name, root)
    cfg, mix = cell.cfg, dict(cell.mix, mode="serve")
    leaves = ref.leaves(cfg)
    model = prog.build(cfg, mix, "cpu")
    prog.load_weights(model, leaves, 5, "cpu")
    data = generator.batches(cfg["vocab_sizes"], 13, 1, 1, 256, cell.mix, 5, "cpu")
    feeds = {k: v[0].numpy() for k, v in data.items() if k != "labels"}
    got = model.predict(feeds)
    params = {(leaf.op, leaf.key): draw(leaf, i, 5, "cpu") for i, leaf in enumerate(leaves)}
    emb = [ref.lookup(cfg, params[(f"table_{i}", "weight")], data[f"sparse_{i}"][0], "float32")
           for i in range(len(cfg["vocab_sizes"]))]
    want = ref.forward(cfg, params, data["dense_features"][0], emb).numpy()
    # bf16 products against f32 ones: a few bf16 roundings of a probability
    assert np.max(np.abs(got - want)) < 2e-2
    assert np.max(np.abs(got - want)) > 0.0  # the port does round: the comparison sees it


def test_training_steps_match_the_port(root):
    cell = harness.load_cell(tinycell.TRAIN, root)
    dev = harness.Device("cpu")
    leaves = ref.leaves(cell.cfg)
    model = prog.build(cell.cfg, cell.mix, "cpu")
    assert prog.storage_dtypes(model, leaves) == {}
    prog.load_weights(model, leaves, 11, "cpu")
    data = train._inputs(cell, 11, dev)
    labels = data.pop("labels")
    feeds = dict(data, **prog.routes(model, {k: v for k, v in data.items() if k.startswith("sparse_")}))
    port = train.port_steps(model, feeds, labels, prog.state_reader(model), leaves, 11, 0.01)
    plain = train.reference_steps(cell, 11, data, labels, dev)
    assert np.allclose(port["losses"], plain["losses"], rtol=1e-3)
    for k in plain["grad"]:
        assert port["grad"][k] == pytest.approx(plain["grad"][k], rel=0.3, abs=1e-3 * max(plain["grad"].values()))


def test_reference_gradients_are_autograd_of_its_loss():
    """The reference's own backward (the rounding Function, sparse rows)
    against torch.autograd of a plain float32 forward."""
    cfg = json.loads((harness.HERE / "configs" / "dlrm-kaggle.json").read_text())
    cfg.update(vocab_sizes=[50, 20000], mlp_bot=[13, 8, 4], mlp_top=[12, 6, 1], table_dtype="float32",
               sparse_feature_size=4)
    p = {(leaf.op, leaf.key): draw(leaf, i, 1, "cpu") for i, leaf in enumerate(ref.leaves(cfg))}
    g = torch.Generator().manual_seed(0)
    dense = torch.randn(32, 13, generator=g)
    sparse = [torch.randint(0, v, (32, 1), generator=g) for v in cfg["vocab_sizes"]]
    labels = torch.randint(0, 2, (32, 1), generator=g).float()
    leaf_p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    emb = [leaf_p[(f"table_{i}", "weight")][sparse[i][:, 0]] for i in range(2)]
    x = ref.forward(cfg, leaf_p, dense, emb)
    loss = ref.bce(x, labels)
    grads = torch.autograd.grad(loss, list(leaf_p.values()))
    q = {k: v.clone() for k, v in p.items()}
    ref.sgd_step(cfg, q, dense, sparse, labels, lr=0.5)
    for (k, v), gr in zip(p.items(), grads):
        assert torch.allclose((v - q[k]) / 0.5, gr, atol=1e-6), k
