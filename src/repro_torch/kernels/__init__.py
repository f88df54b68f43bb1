"""Hand-written CUDA kernels of the query path and the LM, and their
wrappers.

``summary_dot``       router: quantized summary dots ``[Q, L, S] -> [Q, L]``
``gather_dot``        scorer: sparse·dense dots over gathered rows
                      ``[Q, N, nnz] -> [Q, N]``, and the candidate-driven
                      variant over doc ids ``[Q, C]`` plus the forward
                      plane (in-kernel row gather, all-sentinel tiles
                      skipped)
``router_fused``      fuse level 2 router: the flat route (``router_flat``)
                      and the two-stage superblock route (``router_hier``)
                      in one launch each, reading the summary planes in
                      place
``refine_fused``      fuse level 2 refine: one kNN-graph round (expand,
                      dedupe, seen-mask, compact, rescore) per launch
``block_cand``        scorer and adaptive selector, fuse level 1 and 2:
                      the selected blocks' doc ids gathered, sorted,
                      deduped and compacted, one launch a call

``flash_attention``   the LM's prefill attention: online softmax over key
                      tiles with causal, window and key-existence masks,
                      bf16 on the tensor cores (TMA + ``wgmma`` at head
                      dims 64, 112 and 128, ``mma.sync`` at 16 and 32)
                      or float32

The retrieval kernels score a row with the shared row dot of
``common/csrc/row_dot.cuh``, so their scores agree to the bit.

See :mod:`repro_torch.kernels.runtime` for the build and the CPU/CUDA
dispatch rule.
"""
