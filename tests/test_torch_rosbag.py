"""The port's rosbag2 reader and writers against the JAX ones
(`orb_slam3_ros2_tpu/io/rosbag.py`, `tests/test_rosbag.py`,
`tests/test_mcap.py`): CDR payloads and mcap files byte-identical, sqlite
and mcap bags written by either package read by both with the same
messages in the same order (top-level records, and uncompressed and zstd
chunks), and `replay_bag` through the port's System on the CPU equal to
feeding it the same frames directly."""

import os
import struct

import numpy as np
import pytest

from orb_slam3_ros2_tpu.io import rosbag as jbag
from orb_slam3_ros2_tpu_torch.io import rosbag, synthetic
from orb_slam3_ros2_tpu_torch.runtime.system import Sensor, System
from tests.test_torch_e2e_stereo import two_threads  # noqa: F401

SETTINGS = os.path.join(os.path.dirname(__file__), "data", "synth_cam.yaml")
IMG, IMU = "/camera/image_raw", "/camera/imu"


def _fill(mod, w):
    w.add_topic(IMG, "sensor_msgs/msg/Image")
    w.add_topic(IMU, "sensor_msgs/msg/Imu")
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 255, (32, 40)).astype(np.float32)
            for _ in range(3)]
    for k, img in enumerate(imgs):
        for j in range(4):
            t_imu = 1.05 + 0.1 * k + 0.025 * j
            w.write(IMU, t_imu, mod.encode_imu([0.01 * j, 0, 0],
                                               [0, 0, 9.8], t_imu))
        w.write(IMG, 1.1 + 0.1 * k, mod.encode_image(img, 1.1 + 0.1 * k))
    w.close()
    return imgs


def _same_messages(a, b):
    assert len(a) == len(b)
    for (na, ta, ma), (nb, tb, mb) in zip(a, b):
        assert (na, ta) == (nb, tb)
        assert type(ma).__name__ == type(mb).__name__
        for f in vars(mb):
            x, y = getattr(ma, f), getattr(mb, f)
            assert (np.array_equal(x, y) if isinstance(y, np.ndarray)
                    else x == y), f


def test_cdr_payloads_byte_identical():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (48, 64)).astype(np.float32)
    p = rosbag.encode_image(img, t=12.3456789, frame_id="cam0")
    assert p == jbag.encode_image(img, t=12.3456789, frame_id="cam0")
    m, jm = rosbag.decode_image(p), jbag.decode_image(p)
    assert (m.t, m.frame_id) == (jm.t, jm.frame_id)
    assert np.array_equal(m.data, jm.data) and np.array_equal(m.data, img)
    q = rosbag.encode_imu([0.1, -0.2, 0.3], [9.5, 0.01, -0.02], t=5.5,
                          frame_id="imu_link")
    assert q == jbag.encode_imu([0.1, -0.2, 0.3], [9.5, 0.01, -0.02],
                                t=5.5, frame_id="imu_link")
    a, b = rosbag.decode_imu(q), jbag.decode_imu(q)
    for f in ("gyro", "acc", "quat"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
    assert a.t == b.t


def test_decode_rgb_and_16bit_equal_jax():
    rng = np.random.default_rng(2)
    h, w = 8, 10
    for enc, ch, dtype in (("rgb8", 3, np.uint8), ("bgra8", 4, np.uint8),
                           ("mono16", 1, np.uint16)):
        raw = rng.integers(0, np.iinfo(dtype).max, (h, w * ch)).astype(dtype)
        c = rosbag.CdrWriter()
        c.header(1.0, "cam")
        c.uint32(h)
        c.uint32(w)
        c.string(enc)
        c.uint8(0)
        c.uint32(w * ch * raw.itemsize)
        c.bytes_seq(raw.tobytes())
        assert np.array_equal(rosbag.decode_image(c.tobytes()).data,
                              jbag.decode_image(c.tobytes()).data)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sqlite_bag_read_by_both(tmp_path, writer):
    mod = rosbag if writer == "port" else jbag
    d = str(tmp_path / "bag")
    imgs = _fill(mod, mod.Rosbag2Writer(d))
    r, jr = rosbag.Rosbag2Reader(d), jbag.Rosbag2Reader(d)
    assert r.topic_names() == jr.topic_names()
    assert r.guess_topics() == jr.guess_topics() == (IMG, IMU)
    msgs = list(r.messages([IMG, IMU]))
    _same_messages(msgs, list(jr.messages([IMG, IMU])))
    assert len(msgs) == 15
    assert np.array_equal([m.data for n, _, m in msgs if n == IMG][1],
                          imgs[1])
    # the two writers' metadata and message rows agree
    other = str(tmp_path / "other")
    _fill(jbag if writer == "port" else rosbag,
          (jbag if writer == "port" else rosbag).Rosbag2Writer(other))
    assert (open(os.path.join(d, "metadata.yaml")).read()
            == open(os.path.join(other, "metadata.yaml")).read())
    _same_messages(msgs, list(rosbag.Rosbag2Reader(other).messages(
        [IMG, IMU])))


def _chunked(path, out, compression):
    """Rewrap a bag's Message records into one Chunk (the layout rosbag2
    writes with chunking on)."""
    data = open(path, "rb").read()
    body = data[len(rosbag._MCAP_MAGIC):]
    head, msgs, off = [], [], 0
    while off + 9 <= len(body):
        op = body[off]
        ln = struct.unpack_from("<Q", body, off + 1)[0]
        rec = body[off: off + 9 + ln]
        off += 9 + ln
        if op == 0x05:
            msgs.append(rec)
        elif op in (0x01, 0x03, 0x04):
            head.append(rec)
    records = b"".join(msgs)
    stored = records
    if compression == "zstd":
        import zstandard

        stored = zstandard.ZstdCompressor().compress(records)
    chunk_body = (struct.pack("<QQQI", 0, 0, len(records), 0)
                  + rosbag.McapWriter._s(compression)
                  + struct.pack("<Q", len(stored)) + stored)
    chunk = bytes([0x06]) + struct.pack("<Q", len(chunk_body)) + chunk_body
    with open(out, "wb") as f:
        f.write(rosbag._MCAP_MAGIC + b"".join(head) + chunk + bytes([0x0F])
                + struct.pack("<Q", 4) + struct.pack("<I", 0)
                + rosbag._MCAP_MAGIC)
    return out


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mcap_bag_byte_identical_and_read_by_both(tmp_path, writer):
    mod = rosbag if writer == "port" else jbag
    d = str(tmp_path / "bag")
    w = mod.McapWriter(d)
    imgs = _fill(mod, w)
    jd = str(tmp_path / "other")
    other = (jbag if writer == "port" else rosbag).McapWriter(jd)
    _fill(jbag if writer == "port" else rosbag, other)
    assert open(w.path, "rb").read() == open(other.path, "rb").read()
    r, jr = rosbag.Rosbag2Reader(d), jbag.Rosbag2Reader(d)
    assert isinstance(r, rosbag.McapReader)
    assert r.topic_names() == jr.topic_names()
    assert [(t.id, t.name, t.type) for t in r.topics] == [
        (t.id, t.name, t.type) for t in jr.topics]
    assert r.guess_topics() == jr.guess_topics() == (IMG, IMU)
    msgs = list(r.messages([IMG, IMU]))
    _same_messages(msgs, list(jr.messages([IMG, IMU])))
    assert [t for _, t, _ in msgs] == sorted(t for _, t, _ in msgs)
    assert np.array_equal([m.data for n, _, m in msgs if n == IMG][2],
                          imgs[2])
    _same_messages(list(rosbag.Rosbag2Reader(w.path).messages([IMU])),
                   list(jbag.Rosbag2Reader(w.path).messages([IMU])))
    # chunked: uncompressed and zstd, read identically by both
    for comp in ("", "zstd"):
        p = _chunked(w.path, str(tmp_path / f"chunked_{comp or 'raw'}.mcap"),
                     comp)
        _same_messages(list(rosbag.McapReader(p).messages([IMG, IMU])),
                       list(jbag.McapReader(p).messages([IMG, IMU])))


def test_mcap_two_files_merge_in_time_order(tmp_path):
    """A directory of two mcap files whose messages interleave in time:
    both readers merge them into the same stable log-time order."""
    d = tmp_path / "multi"
    for i, name in enumerate(("a", "b")):
        w = rosbag.McapWriter(str(d), bag_name=name)
        w.add_topic(IMU, "sensor_msgs/msg/Imu")
        for j in range(5):
            t = 1.0 + 0.01 * (2 * j + i) if j != 2 else 1.05
            w.write(IMU, t, rosbag.encode_imu([j, i, 0], [0, 0, 9.8], t))
        w.close()
    msgs = list(rosbag.Rosbag2Reader(str(d)).messages([IMU]))
    _same_messages(msgs, list(jbag.Rosbag2Reader(str(d)).messages([IMU])))
    assert len(msgs) == 10


def test_replay_bag_equals_direct_feed(tmp_path, two_threads):  # noqa: F811
    n = 18
    images, _, _, ts = synthetic.render_sequence(
        n_frames=n, width=320, height=240, fx=260.0, fy=260.0, fps=10.0,
        seed=1, plane_depths=(6.0, 9.0), traj_scale=1.6)
    d = str(tmp_path / "bag")
    w = rosbag.McapWriter(d)
    w.add_topic("/image_rect", "sensor_msgs/msg/Image")
    for k in range(n):
        w.write("/image_rect", float(ts[k]) + 1.0,
                rosbag.encode_image(images[k], float(ts[k]) + 1.0))
    w.close()
    slam = System(None, SETTINGS, Sensor.MONOCULAR, device="cpu")
    out = rosbag.replay_bag(slam, d, max_frames=n - 2)
    assert len(out) == n - 2
    direct = System(None, SETTINGS, Sensor.MONOCULAR, device="cpu")
    for k in range(n - 2):
        img = np.clip(images[k], 0, 255).astype(np.uint8).astype(np.float32)
        T = direct.track_monocular(img, float(ts[k]) + 1.0)
        assert np.array_equal(T, out[k][1])
    assert [r["state"] for r in slam.tracking_log] == [
        r["state"] for r in direct.tracking_log]
    assert any(r["state"] == 1 for r in slam.tracking_log)
