"""Hand-written CUDA kernels of the query path and their wrappers.

``summary_dot``       router: quantized summary dots ``[Q, L, S] -> [Q, L]``
``gather_dot``        scorer: sparse·dense dots over gathered rows
                      ``[Q, N, nnz] -> [Q, N]``, and the candidate-driven
                      variant over doc ids ``[Q, C]`` plus the forward
                      plane (in-kernel row gather, all-sentinel tiles
                      skipped)

See :mod:`repro_torch.kernels.runtime` for the build and the CPU/CUDA
dispatch rule.
"""
