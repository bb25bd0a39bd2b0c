"""Training-progress video from checkpoint sample PNGs (counterpart of
neuron_gan_tpu/utils/video.py).

Port of reference utils.py:669-772: sort ``Samples_<ID>_<epoch>.png`` frames
by epoch, cap at 20s@30fps by uniform subsampling, stamp the epoch in the
top-right corner, write an .avi via OpenCV, then shell out to ffmpeg for the
.mp4 and palette-reduced .gif.  cv2 and ffmpeg are optional: without cv2
the call raises an error naming it; without ffmpeg it says so and writes
the .avi only.
"""

import os
import re
import shutil
import subprocess

import numpy as np

from neuron_gan_tpu_torch.utils.monitor import ProgressBar

_FRAME_RE = re.compile(r'(?P<prefix>.+)_(?P<ID>[^_]+)_(?P<Epoch>\d+)\.png$')


def _frame_epoch(filename):
    m = _FRAME_RE.match(filename)
    return int(m.group('Epoch')) if m else None


def make_samples_video(video_filename, frames_dir, video_length=20,
                       frame_rate=30):
    try:
        import cv2
    except ImportError as exc:
        raise RuntimeError('make_samples_video requires OpenCV (the cv2 '
                           'module, package opencv-python)') from exc
    have_ffmpeg = shutil.which('ffmpeg') is not None
    if not have_ffmpeg:
        print('ffmpeg not found: writing .avi only (no .mp4/.gif conversion)')

    frames = [f for f in os.listdir(frames_dir)
              if f.endswith('.png') and _frame_epoch(f) is not None]
    if not frames:
        raise ValueError(f'no Samples_*.png frames in {frames_dir}')
    frames.sort(key=_frame_epoch)

    n_show = int(frame_rate * video_length)
    if len(frames) > n_show:
        idx = np.round(np.linspace(0, len(frames) - 1, n_show)).astype(int)
        frames = [f for i, f in enumerate(frames) if i in set(idx.tolist())]

    color = (255, 255, 255)
    font = cv2.FONT_HERSHEY_SIMPLEX
    fontscale, thickness = 4, 4
    fmt = lambda e: 'epoch:{:5.1f}e+03'.format(e / 1000)
    ts_size, ts_baseline = cv2.getTextSize(fmt(100), font, fontscale, thickness)
    top_pad = ts_size[1] + ts_baseline

    video_basename, video_ext = os.path.splitext(video_filename)
    if video_ext != '.mp4':
        raise ValueError(f'{video_filename}: only .mp4 format is supported')
    first = cv2.imread(os.path.join(frames_dir, frames[0]))
    avi = os.path.join(frames_dir, video_basename + '.avi')
    mp4 = os.path.join(frames_dir, video_filename)
    gif = os.path.join(frames_dir, video_basename + '.gif')
    video_size = (first.shape[1], first.shape[0] + top_pad)
    video_ar = video_size[1] / video_size[0]
    out = cv2.VideoWriter(avi, cv2.VideoWriter_fourcc(*'DIVX'), frame_rate,
                          video_size)

    bar = ProgressBar(len(frames), 'Creating samples video', 'Video created.')
    for f in frames:
        img = cv2.imread(os.path.join(frames_dir, f))
        img = cv2.copyMakeBorder(img, top_pad, 0, 0, 0, cv2.BORDER_CONSTANT,
                                 value=(0, 0, 0))
        epoch_str = fmt(_frame_epoch(f))
        size, _ = cv2.getTextSize(epoch_str, font, fontscale, thickness)
        pos = (video_size[0] - size[0], size[1])  # top-right
        cv2.putText(img, epoch_str, pos, font, fontscale, color, thickness,
                    cv2.LINE_AA)
        out.write(img)
        bar.step()
    out.release()

    if not have_ffmpeg:
        return avi
    w = 720
    subprocess.run(['ffmpeg', '-y', '-loglevel', 'warning', '-i', avi,
                    '-vf', f'scale={w}:-2,setsar=1', mp4], check=False)
    subprocess.run(['ffmpeg', '-y', '-loglevel', 'warning', '-i', avi,
                    '-filter_complex',
                    f'fps=20,scale={w}:-2:flags=lanczos,split[s0][s1];'
                    '[s0]palettegen=max_colors=8[p];[s1][p]paletteuse=dither=bayer',
                    gif],
                   check=False)
    # only drop the intermediate once the mp4 conversion actually succeeded
    if os.path.exists(mp4):
        os.remove(avi)
        return mp4
    return avi


if __name__ == '__main__':
    import argparse
    from neuron_gan_tpu_torch.configs import config

    parser = argparse.ArgumentParser()
    parser.add_argument('--configs', type=str, default='')
    options = parser.parse_args()
    if options.configs:
        config.import_configs(options.configs)
    frames_dir = os.path.join(config.images_dir, config.ID)
    make_samples_video(f'samples_{config.ID}.mp4', frames_dir)
