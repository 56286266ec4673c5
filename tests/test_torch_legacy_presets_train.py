"""``mmtrvpa`` at the patterns of iemocap, cmu-mosei and mmimdb (memory
head dims 50, 60 and 256; ``tests/test_torch_legacy_presets.py``) trained
in lockstep with ``bpx.train.steps.make_train_step`` at the presets' own
recompute: two accumulation steps on one super-batch, the step-1
gradients, the grad norm and the loss trajectory.  fp32 on the CPU, the
tolerances of ``tests/test_torch_train.py``.
"""

import pytest

from tests.test_torch_legacy_presets import PATTERNS, tiny_mmtrvpa
from tests.test_torch_model import _fp32_matmuls  # noqa: F401
from tests.test_torch_train import _lockstep, _no_dropout
from tests.test_torch_loop import few_threads  # noqa: F401

#: label frequencies of the loss, cycled over the classes
FREQS = [5, 2, 9, 1, 4, 3, 6, 2]


@pytest.mark.parametrize("preset", list(PATTERNS))
def test_mmtrvpa_at_the_preset_train_step_lockstep_with_bpx(preset):
    jexp, _, params = tiny_mmtrvpa(preset)
    freqs = [FREQS[i % len(FREQS)] for i in range(jexp.model.n_classes)]
    _lockstep(_no_dropout(jexp), freqs, batch_seeds=(0, 0), params=params)
