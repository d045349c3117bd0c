"""The error the image readers raise on a file Pillow reads and they do
not, and the size check they share."""

# Pillow's largest image: twice ``Image.MAX_IMAGE_PIXELS``, past which it
# raises ``DecompressionBombError``
MAX_PIXELS = 2 * 89_478_485


class UnsupportedImageError(ValueError):
    """An image in a format or a variant of one that the port's readers do
    not decode, though Pillow does (a lossless JPEG of subsampled
    components, a JPEG scan libjpeg decodes with a warning, ...): the
    message names it."""


class RefusedByPillowError(UnsupportedImageError):
    """A kind that Pillow refuses too (a hierarchical or 12-bit JPEG, a PAM
    file, ...): the message names it.  JAX's folder loader skips such a
    file, as it skips any file PIL cannot open, and so does the port's."""


def check_size(fmt: str, w: int, h: int) -> None:
    """Raise ``ValueError`` on an empty image or one past Pillow's limit."""
    if w <= 0 or h <= 0:
        raise ValueError(f"{fmt} size {w}x{h} is not valid")
    if w * h > MAX_PIXELS:
        raise ValueError(f"{fmt} of {w}x{h} pixels is past Pillow's limit of {MAX_PIXELS}")
