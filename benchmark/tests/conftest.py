import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

CELLS = ("pggb-chr22.hg-all", "pggb-chr22.hg-node")


def small_cell(tmp_path, name, n_nodes=3000, **changes):
    """The cell `name` on its configuration cut to n_nodes (and `changes`),
    written under tmp_path."""
    from benchmark.harness import Cell

    cell = Cell.load(name, ROOT)
    with open(cell.config_path) as f:
        cfg = json.load(f)
    cfg.update(n_nodes=n_nodes, **changes)
    path = tmp_path / f"{cfg['name']}-{n_nodes}.json"
    path.write_text(json.dumps(cfg))
    cell.config_path = str(path)
    return cell


@pytest.fixture
def cuda_device():
    """The first card, or a skip where the machine has none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
