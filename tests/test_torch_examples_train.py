"""The linear and ranking twins against their references
(``examples/torch_port/train_{sparse_linear,ranking}.py``), under the
per-line rules of ``test_torch_examples.same_output``: their share of
the example pairs, in a file of their own so ``--dist loadfile`` runs it
beside the other shares."""

import pytest

from test_torch_examples import check_needs_card, check_pair, share


@pytest.mark.parametrize("name", share("test_torch_examples_train.py"))
def test_twin_prints_what_the_reference_prints(name):
    check_pair(name)


@pytest.mark.parametrize("name", share("test_torch_examples_train.py", True))
def test_a_twin_needs_a_card_without_device_cpu(name):
    check_needs_card(name)
