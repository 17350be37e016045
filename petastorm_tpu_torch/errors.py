"""Exception types of the port.

A copy of ``petastorm_tpu/errors.py`` (:9-21): ``NoDataAvailableError`` is
part of the public API, the metadata errors mark a store whose
``_common_metadata`` is missing, malformed or could not be generated.
"""


class PetastormTpuError(Exception):
    """Base class of the port's errors."""


class NoDataAvailableError(PetastormTpuError):
    """A reader has no row groups to read (e.g. all filtered out)."""


class PetastormMetadataError(PetastormTpuError):
    """A store's metadata is missing or malformed."""


class PetastormMetadataGenerationError(PetastormTpuError):
    """Metadata generation failed validation after a store was written."""
