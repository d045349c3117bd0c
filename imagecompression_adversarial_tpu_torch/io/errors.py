"""The error the image readers raise on a file Pillow reads and they do
not."""


class UnsupportedImageError(ValueError):
    """An image in a format or a variant of one that the port's readers do
    not decode, though Pillow does (an animated WebP, a palette BMP, a
    YCCK JPEG, a JPEG scan libjpeg decodes with a warning, ...): the
    message names it."""
