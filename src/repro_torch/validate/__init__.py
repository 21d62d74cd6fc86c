"""repro_torch.validate — the part of the validation stack the store
needs: the content-addressed build cache (:mod:`.build_cache`)."""
from repro_torch.validate.build_cache import BuildCache, BuildCacheStats

__all__ = ["BuildCache", "BuildCacheStats"]
