"""User transforms run on the reader's workers, and the schema they imply.

A copy of ``petastorm_tpu/transform.py`` (``TransformSpec`` :18-70 with
its ``device=`` flag :31-48, ``transform_schema`` :73-90,
``apply_columnar_transform``) and of the row reader's per-row contract
(``readers/row_worker.py`` ``_apply_transform`` :405-409). A
``device=True`` spec of a columnar reader that plans device decode runs
after the decode of the reader's bytes-through columns, on the loader's
device (:func:`petastorm_tpu_torch.ops.decode.build_fused_infeed`);
everywhere else it runs where any spec runs, over CPU tensors
(:func:`run_on_cpu_tensors`). The batch reader's pandas contract lives in
``readers/batch_worker.py``.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from petastorm_tpu_torch.unischema import Unischema, UnischemaField


class TransformSpec:
    """A transform applied on a worker before data reaches the consumer,
    plus the schema change it makes.

    :param func: called with one row dict (``make_reader``), a dict of
        column arrays (``make_columnar_reader``) or a pandas DataFrame
        (``make_batch_reader``), and returns the same kind transformed;
        ``None`` when only fields are selected or removed.
    :param edit_fields: :class:`UnischemaField`\\ s (or 4-tuples
        ``(name, dtype, shape, nullable)``) the transform adds or changes.
    :param removed_fields: names the transform deletes.
    :param selected_fields: if set, the transformed schema keeps exactly
        these fields; exclusive with ``removed_fields``.
    :param device: ``func`` takes and returns a dict of torch tensors (a
        batch's columns, or a row's fields). When a columnar reader plans
        device decode, ``func`` runs after the decode, once a batch: on the
        loader's device when a loader claims the plans, else in the reader
        on the host. Otherwise it runs on the workers, as any spec does,
        over CPU tensors. The reader yields numpy either way, so results do
        not depend on where the decode ran. ``make_batch_reader`` hands it
        a pandas DataFrame, as it hands any spec.
    """

    def __init__(self, func: Optional[Callable] = None,
                 edit_fields: Optional[List] = None,
                 removed_fields: Optional[List[str]] = None,
                 selected_fields: Optional[List[str]] = None,
                 device: bool = False):
        self.func = func
        self.device = bool(device)
        self.edit_fields = [self._as_field(f) for f in (edit_fields or [])]
        self.removed_fields = list(removed_fields or [])
        self.selected_fields = (list(selected_fields)
                                if selected_fields is not None else None)
        if self.selected_fields is not None and self.removed_fields:
            raise ValueError('Only one of removed_fields and selected_fields '
                             'can be specified')

    @staticmethod
    def _as_field(f):
        if isinstance(f, UnischemaField):
            return f
        name, dtype, shape, nullable = f
        return UnischemaField(name, dtype, shape, None, nullable)


def transform_schema(schema: Unischema,
                     transform_spec: TransformSpec) -> Unischema:
    """The :class:`Unischema` after ``transform_spec``."""
    removed = set(transform_spec.removed_fields)
    unknown = removed - set(schema.fields)
    if unknown:
        raise ValueError('removed_fields names unknown fields: {}'
                         .format(sorted(unknown)))
    fields = {name: field for name, field in schema.fields.items()
              if name not in removed}
    for edited in transform_spec.edit_fields:
        fields[edited.name] = edited
    if transform_spec.selected_fields is not None:
        unknown = set(transform_spec.selected_fields) - set(fields)
        if unknown:
            raise ValueError('selected_fields names unknown fields: {}'
                             .format(sorted(unknown)))
        fields = {name: field for name, field in fields.items()
                  if name in transform_spec.selected_fields}
    return Unischema(schema._name + '_transformed', list(fields.values()))


def apply_columnar_transform(transform_spec: TransformSpec,
                             transformed_schema: Unischema, columns):
    """``func`` over a dict of column arrays, its result filtered to the
    transformed schema's fields."""
    if transform_spec.func is not None:
        columns = (run_on_cpu_tensors(transform_spec.func, columns)
                   if transform_spec.device else transform_spec.func(columns))
    return {name: columns[name] for name in transformed_schema.fields
            if name in columns}


def apply_row_transform(transform_spec: TransformSpec,
                        transformed_schema: Unischema, row: dict) -> dict:
    """``func`` over one row dict, its result filtered to the transformed
    schema's fields."""
    if transform_spec.func is not None:
        row = (run_on_cpu_tensors(transform_spec.func, row)
               if transform_spec.device else transform_spec.func(row))
    return {name: row[name] for name in transformed_schema.fields
            if name in row}


def run_on_cpu_tensors(func, values: dict) -> dict:
    """A device spec's ``func`` off the device: its numeric numpy values
    (arrays and scalars) go in as CPU tensors, wrapped, or copied when
    read-only; its tensors come back as numpy. A value it returns as it
    got it comes back as the value it was given."""
    import torch
    given = {}
    for name, value in values.items():
        if (isinstance(value, (np.ndarray, np.generic))
                and value.dtype.kind in 'biuf'):
            array = np.asarray(value)
            given[name] = torch.from_numpy(
                array if array.flags.writeable else array.copy())
    out = func(dict(values, **given))
    return {name: (values[name] if name in given and value is given[name]
                   else value.numpy() if torch.is_tensor(value) else value)
            for name, value in out.items()}
