"""The recsys family: fm, wide-deep, sasrec and bst over one fused
embedding table (``embedding``)."""
