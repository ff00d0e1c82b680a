"""Version info.

The reference identifies each optimization step with a version string passed to
its result logger (reference: src/latest/rayweek1.cpp:967, src/common/common.h:47).
We keep the same convention: VERSION_NAME tags benchmark result records.
"""

__version__ = "0.1.0"

# Tag used in result records (the analog of the reference's "latest"/"stepN").
VERSION_NAME = "jax-latest"
