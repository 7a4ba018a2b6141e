"""Package metadata: installs the `myth` console script
(reference parity: setup.py:125 console_scripts myth=...cli:main)."""

from setuptools import find_packages, setup

setup(
    name="mythril-tpu",
    version="0.1.0",
    description=(
        "TPU-native symbolic-execution security analyzer for EVM bytecode"
    ),
    packages=find_packages(include=["mythril_tpu", "mythril_tpu.*",
                                    "mythril_tpu_torch*"]),
    package_data={"mythril_tpu.support": ["assets/*.txt"],
                  "mythril_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"],
                  "mythril_tpu_torch.native": ["*.cpp", "Makefile"],
                  "mythril_tpu_torch.support": ["assets/*.txt"]},
    include_package_data=True,
    python_requires=">=3.9",
    install_requires=[
        "jax",
        "numpy",
    ],
    entry_points={
        "console_scripts": ["myth=mythril_tpu.interfaces.cli:main"],
        # third-party detector/plugin discovery namespace
        # (reference: pkg_resources entry points "mythril.plugins")
        "mythril_tpu.plugins": [],
    },
)
