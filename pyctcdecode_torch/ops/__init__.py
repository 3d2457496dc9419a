"""Device-side building blocks: hashing, token tables and the merge kernels."""
