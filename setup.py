"""Package setup (parity with reference setup.py)."""

import os

from setuptools import find_packages, setup


def read(fname):
    path = os.path.join(os.path.dirname(__file__), fname)
    with open(path) as f:
        return f.read()


setup(
    name="centernet-tpu",
    version="0.1.0",
    description=(
        "TPU-native CenterNet (Objects as Points): COCO detection and "
        "multi-person pose estimation in JAX/XLA/Pallas"
    ),
    long_description=read("README.md"),
    long_description_content_type="text/markdown",
    packages=find_packages(exclude=("tests",)),
    package_data={
        "centernet_tpu": ["native/*.cc"],
        "centernet_tpu_torch": ["csrc/*.cu"],
    },
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "orbax-checkpoint",
        "numpy",
    ],
    extras_require={
        "data": ["opencv-python", "pillow"],
        "test": ["pytest", "torch"],
    },
    entry_points={
        "console_scripts": [
            "centernet-detection=centernet_tpu.cli.detection:cli_main",
            "centernet-multi-pose=centernet_tpu.cli.multi_pose:cli_main",
            "centernet-test=centernet_tpu.cli.test:cli_test",
        ]
    },
)
