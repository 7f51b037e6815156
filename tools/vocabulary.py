"""Vocabulary converter CLI: DBoW2 text vocabulary -> array-tree binary.

Replaces tools/bin_vocabulary.cc (text -> binary conversion for fast
startup, bin_vocabulary.cc:48-56). Implementation lives in
hyslam_tpu.features.vocab_io.

Usage:
    python -m tools.vocabulary ORBvoc.txt ORBvoc.npz
"""

from hyslam_tpu.features.vocab_io import (  # noqa: F401
    load_dbow2_text, load_vocabulary, main, save_vocabulary,
)

if __name__ == "__main__":
    from hyslam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    raise SystemExit(main())
