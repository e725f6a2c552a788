from setuptools import find_packages, setup

setup(
    name="qppvm_tpu",
    version="0.1.0",
    description="TPU-native whole-body control + MPC engine (JAX/XLA/Pallas)",
    packages=find_packages(exclude=("tests",)),
    # the PyTorch port builds its CUDA kernels from these sources at first use
    package_data={"qppvm_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
)
