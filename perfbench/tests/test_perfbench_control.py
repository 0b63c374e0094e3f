"""The control on the card: the plain reference in the program's place with
TF32 GEMMs (the precision below the configured f32) must fail a limit of
each cell, here at a small size; ``calibrate.py`` reads it at the cells'
own sizes."""
import pytest
import torch

from perfbench import checks, harness
from perfbench.drivers import train
from perfbench.reference.serve import full_logits
from perfbench.tests._small import spec_with_serving


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["gcn-arxiv.train", "gcnii-ppi.train"])
def test_tf32_reference_fails_the_training_limits(workload, cache):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    _, cfg, mix = harness.cell_files(harness.spec(), workload)
    small = dict(cfg, dataset=cfg["dataset"].replace("-like", "-cpu"),
                 num_parts=8, clusters_per_batch=2)
    arrays = harness.dataset(small["dataset"])
    parts = train.reference_parts(small, arrays)
    weights = harness.make_weights(small, 2**31 + 3, torch.device("cuda"))
    got = [train.reference_readings(small, mix, arrays, weights, 2**31 + 3,
                                    "cuda", parts, tf32=tf)
           for tf in (False, True)]
    numbers, _ = checks.train_numbers(got[1], got[0])
    correct, _ = harness.judge(numbers, cfg["limits"])
    assert not correct, numbers


@pytest.mark.gpu
def test_tf32_reference_fails_the_serving_limit(cache):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    _, cfg, _ = harness.cell_files(spec_with_serving(), "gcn-arxiv.serve")
    arrays = harness.dataset("arxiv-cpu")
    weights = harness.make_weights(cfg, 2**31 + 5, torch.device("cuda"))
    ref = full_logits(cfg, arrays, weights)
    tf = full_logits(cfg, arrays, weights, tf32=True)
    nodes = torch.arange(0, 4096, 3)
    number = checks.serve_number([(nodes.numpy(), tf[nodes.cuda()].cpu()
                                   .numpy())], ref)
    assert number > cfg["limits"]["logits"], number
