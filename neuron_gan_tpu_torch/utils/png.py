"""A small PNG codec on the standard library (zlib + struct) and numpy.

The port decodes images with PIL where it imports, as the JAX package does;
a machine without PIL reads and writes PNG through this module:

* ``read_png``: 8- and 16-bit grayscale, RGB and RGBA, non-interlaced,
  all five filter types, to the array PIL's ``np.array(Image.open(f))``
  gives: (H, W) uint8 / uint16 for grayscale, (H, W, 3|4) uint8 for
  RGB(A) (16-bit colour keeps the high byte, as PIL's 8-bit modes do);
* ``png_size``: (height, width) from the header alone;
* ``write_png``: 8-bit grayscale (H, W) or RGB (H, W, 3), unfiltered.

Any other PNG raises ``PngError`` naming the file.
"""

import struct
import zlib

import numpy as np

SIGNATURE = b'\x89PNG\r\n\x1a\n'
# colour type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 6: 4}


class PngError(ValueError):
    pass


def _chunks(data, path):
    if data[:8] != SIGNATURE:
        raise PngError(f'{path} is not a PNG file')
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise PngError(f'{path}: truncated {kind!r} chunk')
        yield kind, body
        pos += 12 + length
        if kind == b'IEND':
            return
    raise PngError(f'{path}: no IEND chunk')


def _header(body, path):
    width, height, depth, ctype, comp, filt, interlace = struct.unpack(
        '>IIBBBBB', body)
    if ctype not in _CHANNELS or depth not in (8, 16):
        raise PngError(f'{path}: colour type {ctype} at {depth} bits is not '
                       'supported without PIL (grayscale, RGB and RGBA at '
                       '8 or 16 bits are)')
    if comp or filt or interlace:
        raise PngError(f'{path}: interlaced or non-standard PNG is not '
                       'supported without PIL')
    return height, width, depth, _CHANNELS[ctype]


def png_size(path):
    """(height, width) of a PNG file, from its header."""
    with open(path, 'rb') as f:
        head = f.read(33)
    kind, body = next(_chunks(head, path))
    if kind != b'IHDR':
        raise PngError(f'{path}: the first chunk is not IHDR')
    return _header(body, path)[:2]


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw, height, stride, bpp, path):
    """The scanlines' bytes with each row's filter undone, (H, stride)."""
    if len(raw) < height * (stride + 1):
        raise PngError(f'{path}: image data is truncated')
    rows = np.frombuffer(raw, np.uint8)[:height * (stride + 1)].reshape(
        height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:   # Sub: a running sum along each byte lane
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:   # Up
            cur = line + prev
        elif kind in (3, 4):  # Average, Paeth: sequential along the row
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    pred = _paeth(a, b, up[i - bpp] if i >= bpp else 0)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise PngError(f'{path}: unknown filter type {kind}')
        out[y] = cur
        prev = out[y]
    return out


def read_png(path):
    """Decode a PNG file to the array PIL gives for it (module docstring)."""
    with open(path, 'rb') as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b'IHDR':
            header = _header(body, path)
        elif kind == b'IDAT':
            idat.append(body)
    if header is None or not idat:
        raise PngError(f'{path}: missing IHDR or IDAT')
    height, width, depth, channels = header
    bpp = channels * depth // 8
    rows = _unfilter(zlib.decompress(b''.join(idat)), height, width * bpp,
                     bpp, path)
    if depth == 16:
        arr = rows.view('>u2').reshape(height, width, channels)
        arr = (arr.astype(np.uint16) if channels == 1
               else (arr >> 8).astype(np.uint8))
    else:
        arr = rows.reshape(height, width, channels)
    return arr[..., 0] if channels == 1 else arr


def _chunk(kind, body):
    return (struct.pack('>I', len(body)) + kind + body
            + struct.pack('>I', zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path, arr):
    """Write (H, W) or (H, W, 1) uint8 as grayscale, (H, W, 3) as RGB."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise PngError(f'{path}: write_png takes uint8, got {arr.dtype}')
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    if arr.ndim == 2:
        ctype = 0
    elif arr.ndim == 3 and arr.shape[-1] == 3:
        ctype = 2
    else:
        raise PngError(f'{path}: write_png takes (H, W) or (H, W, 3), got '
                       f'{arr.shape}')
    height, width = arr.shape[:2]
    rows = np.ascontiguousarray(arr).reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack('>IIBBBBB', width, height, 8, ctype, 0, 0, 0)
    with open(path, 'wb') as f:
        f.write(SIGNATURE + _chunk(b'IHDR', ihdr)
                + _chunk(b'IDAT', zlib.compress(raw.tobytes(), 6))
                + _chunk(b'IEND', b''))
