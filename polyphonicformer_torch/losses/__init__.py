"""Training losses with the reference's mmdet semantics."""
