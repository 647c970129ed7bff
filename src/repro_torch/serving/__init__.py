from repro_torch.serving.decode import (cache_specs, init_cache,  # noqa: F401
                                        make_decode_step, make_prefill)
