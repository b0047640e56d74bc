"""Small shapes of the benchmark's cells, for runs on the CPU."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from nwbench import harness  # noqa: E402

SEED = 2 ** 31 + 977
# a few threads a test process: parallel workers on many threads each
# oversubscribe the CPU and run many times slower
torch.set_num_threads(2)


def small_cell(name: str):
    """(cell, config, mix) of a cell at a size a CPU run holds: a 20,000 x
    64 base and 64 queries a call for the kNN cells; e5-small-v2's widths
    and 40 texts a call for the encoder's."""
    cell, config, mix = (copy.deepcopy(x) for x in harness.load_cell(name))
    if cell["driver"] == "knn":
        config["knn"].update(base_rows=20000, queries=64, dim=64, k=10)
        if mix.get("clusters"):
            mix["clusters"] = 200
    else:
        config.update(model_name="intfloat/e5-small-v2", hidden_size=384,
                      num_hidden_layers=12, num_attention_heads=12,
                      intermediate_size=1536)
        mix["texts_per_call"] = 40
        # e5-small-v2's 12 layers on the CPU read smaller gaps than
        # e5-large-v2's 24 on the card: the program ~0.005, the fp8
        # control ~0.03 (the cells' limits are set for e5-large)
        cell["limits"] = {"emb_gap": 0.015}
    cell["check_sample"] = 16
    return cell, config, mix


@pytest.fixture
def cpu_run():
    """run(name, traced=False, cell_edit=None, mix_edit=None) -> (result,
    checks, driver) of one short run of a small cell on the CPU."""
    def run(name, traced=False, cell_edit=None, mix_edit=None):
        import time
        cell, config, mix = small_cell(name)
        if cell_edit:
            cell_edit(cell)
        if mix_edit:
            mix_edit(mix)
        return harness.run_cell(name, cell, config, mix, SEED, 0.2, traced,
                                "cpu", time.perf_counter())
    return run
