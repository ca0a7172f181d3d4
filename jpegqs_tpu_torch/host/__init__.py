from .jpegio import (JpegCoefFile, JpegImage, ComponentData, read_coefficients,
                     encode_pixels, decode_pixels, image_from_arrays,
                     JCS_YCBCR, DCTSIZE, DCTSIZE2)
