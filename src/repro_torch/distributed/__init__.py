"""Model parallelism over ``torch.distributed`` (port of
``repro/distributed``' sharding helpers and parameter specs): the
ambient mesh and logical axes (``sharding``), the autograd-aware
collectives every exchange goes through (``collectives``) and the
rule-based specs of parameters, optimizer state and caches
(``param_sharding``)."""
