"""The host→device edge: pinned staging and async prefetch."""
