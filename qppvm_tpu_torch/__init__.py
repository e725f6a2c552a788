"""PyTorch + CUDA port of qppvm_tpu's batched whole-body-control tick.

The package mirrors ``qppvm_tpu``'s module layout. It imports ``torch`` and
never ``jax``; ``qppvm_tpu`` stays the numerical reference that the
``tests/test_torch_*.py`` parity tests hold it to.

Every function on the tick takes tensors with a written-out leading batch
dimension ``B`` (``B = 1`` is the unbatched tick), so the level QP solver
receives the whole batch in one call and its CUDA kernel
(``csrc/level_qp.cu``) sees all ``B`` problems in one launch.
"""
from qppvm_tpu_torch.precision import pin_f32_matmuls

pin_f32_matmuls()
