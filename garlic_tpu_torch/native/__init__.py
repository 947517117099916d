"""Native (C++) host kernels of the port: the streaming TPED and TGLS
parsers, the exact float64 rolling-LOD engine, the coverage packer and
run extractor, the .freq.gz reader and writer, and the content hash.

Built on demand with g++ into build/garlic_tpu_torch/ and loaded via
ctypes (native/build.py).  The library is required: when g++ cannot
build it, library() raises BuildError.
"""

from .build import (  # noqa: F401
    BuildError,
    assemble_runs_native,
    covered_pack_native,
    filter_columns_native,
    filter_pack_2bit_native,
    gsl_sd_native,
    hash128_native,
    library,
    library_path,
    lod_windows_exact_native,
    lod_windows_exact_tbl_native,
    lod_windows_exact_thin_native,
    pack_2bit_padded_native,
    parse_tgls_native,
    parse_tped_native,
    read_freq_native,
    set_native_threads,
    unpack_2bit_native,
    write_freq_chrom_native,
)
