"""Rewrite a store's compressed ndarray columns as plain ``NdarrayCodec`` so
they become device-decode eligible.

The port's copy of ``petastorm_tpu/etl/repack.py``. A
``CompressedNdarrayCodec`` (zlib) column has no device decode: inflate is
a host algorithm, so a bytes-through reader leaves it to the host
(:mod:`petastorm_tpu_torch.ops.decode`). Paying zlib once, when the store
is copied, leaves the raw ``np.save`` layout that the device decode reads
as a header strip and a reinterpretation of the bytes. Parquet's own
compression (snappy by default) still applies on top.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

from petastorm_tpu_torch.codecs import CompressedNdarrayCodec, NdarrayCodec
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

logger = logging.getLogger(__name__)


def still_ineligible_after_repack(schema: Unischema,
                                  repacked: List[str]) -> Dict[str, str]:
    """``{name: reason}`` for repacked fields that still decline device
    decode after the codec swap (``nullable=True``, wildcard shapes,
    non-numeric or big-endian dtypes): they decode on the host either
    way."""
    out: Dict[str, str] = {}
    for name in repacked:
        field = schema.fields[name]
        reason = field.codec.device_decode_unsupported_reason(field)
        if reason:
            out[name] = reason
    return out


def repack_schema(schema: Unischema,
                  fields: Optional[List[str]] = None
                  ) -> Tuple[Unischema, List[str]]:
    """``(repacked schema, repacked names)``: every
    ``CompressedNdarrayCodec`` field (or just the named ``fields``) with
    ``NdarrayCodec`` instead, everything else as it was. Raises
    ``ValueError`` when ``fields`` names a column that is not
    compressed-ndarray encoded."""
    wanted = set(fields) if fields is not None else None
    unknown = (wanted or set()) - set(schema.fields)
    if unknown:
        raise ValueError('repack fields name unknown columns: {}'.format(
            sorted(unknown)))
    out_fields = []
    repacked = []
    for name, field in schema.fields.items():
        eligible = isinstance(field.codec, CompressedNdarrayCodec)
        if wanted is not None and name in wanted and not eligible:
            raise ValueError(
                'field {!r} is not CompressedNdarrayCodec-encoded ({}); '
                'only zlib ndarray columns repack'.format(
                    name, type(field.codec).__name__))
        if eligible and (wanted is None or name in wanted):
            out_fields.append(UnischemaField(name, field.numpy_dtype,
                                             field.shape, NdarrayCodec(),
                                             field.nullable))
            repacked.append(name)
        else:
            out_fields.append(field)
    out_schema = Unischema(schema._name + '_repacked', out_fields)
    for name, reason in still_ineligible_after_repack(out_schema,
                                                      repacked).items():
        logger.warning(
            'repack_schema: field %r stays device-INELIGIBLE after the '
            'codec swap (%s); the repack pays zlib up front but the column '
            'still decodes on the host matrix', name, reason)
    return out_schema, repacked


def repack_to_ndarray_codec(source_url: str, output_url: str,
                            fields: Optional[List[str]] = None,
                            row_group_size_mb: float = 4.0,
                            compression: str = 'snappy',
                            overwrite: bool = False) -> Dict:
    """Write a device-decode eligible copy of ``source_url`` at
    ``output_url``: compressed ndarray columns are inflated once and
    stored as raw ``np.save`` payloads. Returns ``rows``,
    ``repacked_fields``, ``output_url`` and ``still_ineligible``. The copy
    streams through a columnar reader, one
    row group at a time, decoded on the host (no loader claims the
    reader's plans)."""
    from petastorm_tpu_torch.etl.dataset_metadata import (get_schema,
                                                          materialize_dataset)
    from petastorm_tpu_torch.fs import (get_filesystem_and_path_or_paths,
                                        normalize_dir_url)
    from petastorm_tpu_torch.reader import make_columnar_reader

    fs, path, _ = get_filesystem_and_path_or_paths(
        normalize_dir_url(source_url))
    schema = get_schema(path, filesystem=fs)
    out_schema, repacked = repack_schema(schema, fields)
    rows = 0
    with materialize_dataset(output_url, out_schema,
                             row_group_size_mb=row_group_size_mb,
                             compression=compression,
                             overwrite=overwrite) as writer:
        with make_columnar_reader(source_url, num_epochs=1,
                                  shuffle_row_groups=False) as reader:
            names = list(out_schema.fields)
            for batch in reader:
                columns = {name: getattr(batch, name) for name in names}
                n = len(next(iter(columns.values()))) if columns else 0
                for i in range(n):
                    writer.write_row({name: col[i]
                                      for name, col in columns.items()})
                rows += n
    return {'rows': rows, 'repacked_fields': repacked,
            'output_url': output_url,
            'still_ineligible': still_ineligible_after_repack(out_schema,
                                                              repacked)}
