"""Each fault a cell can have, planted under the timed path, turns
``correct`` false: the run is driven whole on the CPU (the harness's look
for a card skipped), with the limits the configuration states."""
import pytest

from perfbench import faults
from perfbench.drivers import serve, train
from perfbench.tests._small import small_ctx


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_training_fault_is_caught(fault, cache):
    ctx = small_ctx("gcn-arxiv.train")
    res = train.run(ctx, plant=faults.TRAIN[fault])
    assert not res["correct"], res["checks"]


def test_sound_training_run_is_correct_at_the_stated_limits(cache):
    res = train.run(small_ctx("gcn-arxiv.train"))
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", sorted(faults.SERVE))
def test_serving_fault_is_caught(fault, cache):
    ctx = small_ctx("gcn-arxiv.serve")
    res = serve.run(ctx, plant=faults.SERVE[fault])
    assert not res["correct"], res["checks"]


def test_sound_serving_run_is_correct_at_the_stated_limits(cache):
    res = serve.run(small_ctx("gcn-arxiv.serve"))
    assert res["correct"], res["checks"]
