"""vpt_torch.kernels.diff against vpt's differentiable pair, sampler
"random": the image and the P-vector gradient at one seed. The helpers and
the criteria are tests/test_torch_diff.py's; this is a file of its own so
that the two vpt references (about 80 s each) run on different workers.
"""
import pytest

from test_torch_diff import check_gradient, check_image, vpt_reference


@pytest.fixture(scope="module")
def ref():
    return vpt_reference("random", train=False)


def test_fwd_plain_matches_vpt(ref):
    check_image(ref, "random")


def test_bwd_plain_matches_vpt_per_entry(ref):
    check_gradient(ref, "random")
