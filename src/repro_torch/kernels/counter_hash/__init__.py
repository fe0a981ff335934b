"""The port's counter-based noise: SplitMix64 of (seed, slot, site, index)."""
