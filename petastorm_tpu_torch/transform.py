"""User transforms run on the reader's workers, and the schema they imply.

A copy of ``petastorm_tpu/transform.py`` (``TransformSpec`` :18-70,
``transform_schema`` :73-90, ``apply_columnar_transform``) without the
``device=`` flag, which fuses a transform into the JAX package's jitted
device decode and has no counterpart here.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from petastorm_tpu_torch.unischema import Unischema, UnischemaField


class TransformSpec:
    """A transform applied on a worker before data reaches the consumer,
    plus the schema change it makes.

    :param func: called with a dict of column arrays (``make_columnar_reader``)
        and returns the transformed dict; ``None`` when only fields are
        selected or removed.
    :param edit_fields: :class:`UnischemaField`\\ s (or 4-tuples
        ``(name, dtype, shape, nullable)``) the transform adds or changes.
    :param removed_fields: names the transform deletes.
    :param selected_fields: if set, the transformed schema keeps exactly
        these fields; exclusive with ``removed_fields``.
    """

    def __init__(self, func: Optional[Callable] = None,
                 edit_fields: Optional[List] = None,
                 removed_fields: Optional[List[str]] = None,
                 selected_fields: Optional[List[str]] = None):
        self.func = func
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
    return Unischema(schema.name + '_transformed', list(fields.values()))


def apply_columnar_transform(transform_spec: TransformSpec,
                             transformed_schema: Unischema, columns):
    """``func`` over a dict of column arrays, its result filtered to the
    transformed schema's fields."""
    if transform_spec.func is not None:
        columns = transform_spec.func(columns)
    return {name: columns[name] for name in transformed_schema.fields
            if name in columns}
