from repro_torch.serve.engine import (LMDecoder, RetrievalResult,
                                      SeismicServer)

__all__ = ["LMDecoder", "RetrievalResult", "SeismicServer"]
