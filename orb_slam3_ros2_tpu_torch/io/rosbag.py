"""rosbag2 (.db3 / sqlite3) reader with CDR deserialization — no ROS needed.

The reference replays recorded bags through the live stack
(`launch/mapping.launch.py:167-190` wires `ros2 bag play`
into the SLAM node); this module gives the same capability standalone: open
a rosbag2 sqlite3 file, decode `sensor_msgs/msg/Image`,
`sensor_msgs/msg/CompressedImage` and `sensor_msgs/msg/Imu` from their CDR
wire format, and stream (timestamp, payload) tuples suitable for
`System.track_monocular` — using only the Python standard library plus
numpy (and cv2 only for compressed images).

rosbag2 sqlite schema (verified against the rosbag2 storage plugin):
    topics(id, name, type, serialization_format, offered_qos_profiles)
    messages(id, topic_id, timestamp, data)

CDR notes: 4-byte encapsulation header (representation id + options), then
XCDR1 little-endian payload; primitives are aligned to their own size
relative to the payload start; strings are uint32 length INCLUDING the
NUL terminator, then bytes.

Copied from `orb_slam3_ros2_tpu/io/rosbag.py` (numpy, sqlite3; cv2 for
compressed images), with `replay_bag` over the port's `ImuPoint`. One
change, which yields the same messages in the same order: `McapReader`
reads each file's schemas and channels in one pass when it opens it
(the JAX reader makes two), and `messages()` sorts the selected records
undecoded and decodes each one as it is yielded (the JAX reader decodes
every message before it sorts). It still reads each file whole on each
`messages()` call and keeps the selected payloads until they are yielded;
it does not use the chunk or message indexes.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import sqlite3
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np


class CdrReader:
    """Minimal XCDR1 little-endian reader (the ROS 2 default)."""

    def __init__(self, buf: bytes):
        # encapsulation: {0x00, 0x01} = CDR_LE, then 2 options bytes
        if len(buf) < 4:
            raise ValueError("CDR payload too short")
        if buf[1] not in (0x00, 0x01):
            raise ValueError(f"unknown CDR representation {buf[:2]!r}")
        self.little = buf[1] == 0x01
        self.buf = buf
        self.pos = 4  # alignment is relative to this origin

    def _align(self, size: int):
        off = (self.pos - 4) % size
        if off:
            self.pos += size - off

    def _unpack(self, fmt: str, size: int):
        self._align(size)
        end = self.pos + size
        (v,) = struct.unpack_from(("<" if self.little else ">") + fmt,
                                  self.buf, self.pos)
        self.pos = end
        return v

    def uint8(self):
        return self._unpack("B", 1)

    def int32(self):
        return self._unpack("i", 4)

    def uint32(self):
        return self._unpack("I", 4)

    def float64(self):
        return self._unpack("d", 8)

    def float64_array(self, n: int) -> np.ndarray:
        self._align(8)
        out = np.frombuffer(self.buf, dtype="<f8" if self.little else ">f8",
                            count=n, offset=self.pos)
        self.pos += 8 * n
        return out.astype(np.float64)

    def string(self) -> str:
        n = self.uint32()
        s = self.buf[self.pos:self.pos + n]
        self.pos += n
        return s.rstrip(b"\x00").decode("utf-8", errors="replace")

    def bytes_seq(self) -> bytes:
        n = self.uint32()
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def header(self) -> Tuple[float, str]:
        sec = self.int32()
        nsec = self.uint32()
        frame_id = self.string()
        return sec + nsec * 1e-9, frame_id


@dataclasses.dataclass
class ImageMsg:
    t: float          # header stamp, seconds
    frame_id: str
    data: np.ndarray  # (H, W) float32 grayscale


@dataclasses.dataclass
class ImuMsg:
    t: float
    gyro: np.ndarray  # (3,)
    acc: np.ndarray   # (3,)
    quat: np.ndarray  # (4,) (x, y, z, w) as on the wire


_ENCODING_CHANNELS = {
    "mono8": 1, "8UC1": 1, "mono16": 1, "16UC1": 1,
    "bgr8": 3, "rgb8": 3, "8UC3": 3, "bgra8": 4, "rgba8": 4,
}


def decode_image(buf: bytes) -> ImageMsg:
    """sensor_msgs/msg/Image → grayscale float32 (the engine's input form,
    mirroring the wrapper's cv_bridge MONO8 conversion,
    `src/imu_mono_realsense.cpp:294-310`)."""
    r = CdrReader(buf)
    t, frame_id = r.header()
    height = r.uint32()
    width = r.uint32()
    encoding = r.string()
    r.uint8()   # is_bigendian
    step = r.uint32()
    raw = r.bytes_seq()

    ch = _ENCODING_CHANNELS.get(encoding)
    if ch is None:
        raise ValueError(f"unsupported image encoding {encoding!r}")
    if "16" in encoding:
        arr = np.frombuffer(raw, np.uint16).reshape(height, step // 2)
        arr = (arr[:, : width * ch] / 257.0).astype(np.float32)
    else:
        arr = np.frombuffer(raw, np.uint8).reshape(height, step)
        arr = arr[:, : width * ch].astype(np.float32)
    if ch > 1:
        arr = arr.reshape(height, width, ch)
        if encoding.startswith("rgb") or encoding.startswith("rgba"):
            w = np.array([0.299, 0.587, 0.114])
        else:  # bgr order
            w = np.array([0.114, 0.587, 0.299])
        arr = arr[..., :3] @ w.astype(np.float32)
    else:
        arr = arr.reshape(height, width)
    return ImageMsg(t=t, frame_id=frame_id, data=arr.astype(np.float32))


def decode_compressed_image(buf: bytes) -> ImageMsg:
    """sensor_msgs/msg/CompressedImage (jpeg/png) → grayscale float32."""
    import cv2

    r = CdrReader(buf)
    t, frame_id = r.header()
    r.string()  # format, e.g. "jpeg"
    raw = r.bytes_seq()
    img = cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise ValueError("failed to decode compressed image")
    return ImageMsg(t=t, frame_id=frame_id, data=img.astype(np.float32))


def decode_imu(buf: bytes) -> ImuMsg:
    """sensor_msgs/msg/Imu (orientation + covariances skipped into arrays)."""
    r = CdrReader(buf)
    t, _ = r.header()
    quat = r.float64_array(4)          # x, y, z, w
    r.float64_array(9)                 # orientation covariance
    gyro = r.float64_array(3)
    r.float64_array(9)                 # angular velocity covariance
    acc = r.float64_array(3)
    # linear acceleration covariance left unread (tail)
    return ImuMsg(t=t, gyro=gyro, acc=acc, quat=quat)


_DECODERS = {
    "sensor_msgs/msg/Image": decode_image,
    "sensor_msgs/msg/CompressedImage": decode_compressed_image,
    "sensor_msgs/msg/Imu": decode_imu,
}


@dataclasses.dataclass
class TopicInfo:
    id: int
    name: str
    type: str


class Rosbag2Reader:
    """Open a rosbag2 directory or file — sqlite3 (.db3) or mcap storage.

    mcap is rosbag2's newer default storage plugin; bags recorded by a
    current `ros2 bag record` replay through the same interface
    (`launch/mapping.launch.py:167-190` replays whatever
    storage the user recorded). mcap files dispatch to `McapReader`."""

    def __new__(cls, path: str):
        if cls is Rosbag2Reader:
            if (path.endswith(".mcap")
                    or (os.path.isdir(path)
                        and not glob.glob(os.path.join(path, "*.db3"))
                        and glob.glob(os.path.join(path, "*.mcap")))):
                return super().__new__(McapReader)
        return super().__new__(cls)

    def __init__(self, path: str):
        if os.path.isdir(path):
            dbs = sorted(glob.glob(os.path.join(path, "*.db3")))
            if not dbs:
                raise FileNotFoundError(f"no .db3 under {path}")
            self.db_paths = dbs
        else:
            self.db_paths = [path]
        self.topics: List[TopicInfo] = []
        con = sqlite3.connect(self.db_paths[0])
        try:
            for tid, name, typ in con.execute(
                    "SELECT id, name, type FROM topics"):
                self.topics.append(TopicInfo(id=tid, name=name, type=typ))
        finally:
            con.close()

    def topic_names(self) -> List[str]:
        return [t.name for t in self.topics]

    def _topic(self, name: str) -> TopicInfo:
        for t in self.topics:
            if t.name == name:
                return t
        raise KeyError(
            f"topic {name!r} not in bag (have {self.topic_names()})")

    def messages(self, topics: List[str]) -> Iterator[Tuple[str, float, object]]:
        """Yield (topic_name, bag_timestamp_s, decoded_msg) in time order."""
        infos = {self._topic(n).id: self._topic(n) for n in topics}
        for db in self.db_paths:
            con = sqlite3.connect(db)
            try:
                q = ("SELECT topic_id, timestamp, data FROM messages "
                     f"WHERE topic_id IN ({','.join('?' * len(infos))}) "
                     "ORDER BY timestamp")
                for tid, ts, data in con.execute(q, list(infos)):
                    info = infos[tid]
                    dec = _DECODERS.get(info.type)
                    if dec is None:
                        raise ValueError(
                            f"no decoder for message type {info.type!r}")
                    yield info.name, ts * 1e-9, dec(data)
            finally:
                con.close()

    def guess_topics(self) -> Tuple[Optional[str], Optional[str]]:
        """(image_topic, imu_topic) best guesses by message type."""
        img = imu = None
        for t in self.topics:
            if img is None and t.type in (
                    "sensor_msgs/msg/Image", "sensor_msgs/msg/CompressedImage"):
                img = t.name
            if imu is None and t.type == "sensor_msgs/msg/Imu":
                imu = t.name
        return img, imu


# ---------------------------------------------------------------------------
# mcap storage (rosbag2's newer default plugin) — pure-python framing over
# the same CDR decoders. Spec: https://mcap.dev/spec (magic + opcode/length
# framed records; Schema 0x03 / Channel 0x04 / Message 0x05 / Chunk 0x06).
# ---------------------------------------------------------------------------

_MCAP_MAGIC = b"\x89MCAP0\r\n"


def _mcap_str(buf: bytes, off: int) -> Tuple[str, int]:
    n = struct.unpack_from("<I", buf, off)[0]
    return bytes(buf[off + 4: off + 4 + n]).decode("utf-8"), off + 4 + n


class McapReader(Rosbag2Reader):
    """Sequential-scan mcap reader with the Rosbag2Reader interface.

    Handles top-level Message records and uncompressed or zstd/lz4 Chunks
    (compressed chunks require the `zstandard`/`lz4` modules; absent
    modules raise a clear error instead of silently skipping data)."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            files = sorted(glob.glob(os.path.join(path, "*.mcap")))
            if not files:
                raise FileNotFoundError(f"no .mcap under {path}")
            self.paths = files
        else:
            self.paths = [path]
        self.topics = []
        self._channels: dict = {}  # file -> {channel_id: topic name}
        # one pass per file: the channels (topic names) and the schemas
        # (message types; rosbag2 sets the CHANNEL's metadata but the TYPE
        # is the schema's name)
        for p in self.paths:
            chans = {}
            schemas = {}
            chan_schema = {}
            for op, body in self._records(p):
                if op == 0x03:  # Schema: id, name, encoding, data
                    sid = struct.unpack_from("<H", body, 0)[0]
                    name, _ = _mcap_str(body, 2)
                    schemas[sid] = name
                elif op == 0x04:  # Channel: id, schema id, topic, ...
                    cid = struct.unpack_from("<H", body, 0)[0]
                    chan_schema[cid] = struct.unpack_from("<H", body, 2)[0]
                    chans[cid], _ = _mcap_str(body, 4)
            self._channels[p] = chans
            for cid, topic in chans.items():
                typ = schemas.get(chan_schema.get(cid, -1), "")
                # mcap schema names use '/' paths identical to ROS types
                if not any(t.name == topic for t in self.topics):
                    self.topics.append(TopicInfo(id=cid, name=topic,
                                                 type=typ))

    # -- record framing --------------------------------------------------

    @staticmethod
    def _iter_buf_records(buf):
        """(opcode, body) of each record of `buf`; the bodies are
        memoryview slices (no copy)."""
        buf = memoryview(buf)
        off = 0
        n = len(buf)
        while off + 9 <= n:
            op = buf[off]
            ln = struct.unpack_from("<Q", buf, off + 1)[0]
            yield op, buf[off + 9: off + 9 + ln]
            off += 9 + ln

    def _records(self, path: str):
        """Yield (opcode, body) for every record, descending into chunks."""
        with open(path, "rb") as f:
            data = f.read()
        if not data.startswith(_MCAP_MAGIC):
            raise ValueError(f"{path}: not an mcap file")
        data = memoryview(data)[len(_MCAP_MAGIC):]
        for op, body in self._iter_buf_records(data):
            if op == 0x06:  # Chunk
                # message_start/end (16) + uncompressed_size (8) + crc (4)
                comp, off = _mcap_str(body, 28)
                rec_len = struct.unpack_from("<Q", body, off)[0]
                records = body[off + 8: off + 8 + rec_len]
                if comp == "":
                    pass
                elif comp == "zstd":
                    try:
                        import zstandard
                    except ImportError as e:
                        raise RuntimeError(
                            "mcap chunk is zstd-compressed; install "
                            "`zstandard` to read this bag") from e
                    records = zstandard.ZstdDecompressor().decompress(
                        records,
                        max_output_size=struct.unpack_from(
                            "<Q", body, 16)[0])
                elif comp == "lz4":
                    try:
                        import lz4.frame
                    except ImportError as e:
                        raise RuntimeError(
                            "mcap chunk is lz4-compressed; install "
                            "`lz4` to read this bag") from e
                    records = lz4.frame.decompress(records)
                else:
                    raise ValueError(f"unknown mcap compression {comp!r}")
                yield from self._iter_buf_records(records)
            elif op == 0x0F:  # DataEnd → stop before the summary section
                return
            else:
                yield op, body

    def messages(self, topics: List[str]) -> Iterator[Tuple[str, float, object]]:
        """Yield (topic_name, log_time_s, decoded_msg) in log-time order
        (a stable sort: ties keep file order). Each message is decoded as
        it is yielded."""
        want = {n: self._topic(n) for n in topics}
        decoders = {}
        for name, info in want.items():
            decoders[name] = _DECODERS.get(info.type)
            if decoders[name] is None:
                raise ValueError(
                    f"no decoder for message type {info.type!r}")
        out = []
        for p in self.paths:
            names = self._channels[p]
            for op, body in self._records(p):
                if op != 0x05:  # Message
                    continue
                cid = struct.unpack_from("<H", body, 0)[0]
                name = names.get(cid)
                if name not in want:
                    continue
                log_time = struct.unpack_from("<Q", body, 6)[0]
                out.append((log_time * 1e-9, name, body[22:]))
        out.sort(key=lambda x: x[0])
        for t, name, payload in out:
            yield name, t, decoders[name](bytes(payload))


class McapWriter:
    """Minimal valid mcap writer (uncompressed, unchunked, no indexes) —
    produces files stock mcap/rosbag2 tooling and `McapReader` open."""

    def __init__(self, out_dir: str, bag_name: str = "bag"):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, f"{bag_name}_0.mcap")
        self._f = open(self.path, "wb")
        self._f.write(_MCAP_MAGIC)
        # the JAX writer's library name, so that both write the same bytes
        self._record(0x01, self._s("ros2") + self._s("orb_slam3_ros2_tpu"))
        self._schemas: dict = {}
        self._chans: dict = {}
        self._seq = 0

    @staticmethod
    def _s(s: str) -> bytes:
        b = s.encode("utf-8")
        return struct.pack("<I", len(b)) + b

    def _record(self, op: int, body: bytes):
        self._f.write(bytes([op]) + struct.pack("<Q", len(body)) + body)

    def add_topic(self, name: str, type_: str):
        if type_ not in self._schemas:
            sid = len(self._schemas) + 1
            self._schemas[type_] = sid
            self._record(0x03, struct.pack("<H", sid) + self._s(type_)
                         + self._s("ros2msg") + struct.pack("<I", 0))
        cid = len(self._chans) + 1
        self._chans[name] = cid
        self._record(0x04, struct.pack("<HH", cid, self._schemas[type_])
                     + self._s(name) + self._s("cdr")
                     + struct.pack("<I", 0))

    def write(self, topic: str, t: float, payload: bytes):
        ts = int(round(t * 1e9))
        self._record(0x05, struct.pack("<HIQQ", self._chans[topic],
                                       self._seq, ts, ts) + payload)
        self._seq += 1

    def close(self):
        self._record(0x0F, struct.pack("<I", 0))          # DataEnd
        self._record(0x02, struct.pack("<QQI", 0, 0, 0))  # Footer
        self._f.write(_MCAP_MAGIC)
        self._f.close()


# ---------------------------------------------------------------------------
# Writing (ros2 bag record parity: mapping.launch.py:191-213 records the
# image+imu topics for later replay; this writer produces bags the reader
# above — and stock rosbag2 — can open)
# ---------------------------------------------------------------------------


class CdrWriter:
    """XCDR1 little-endian encoder (inverse of CdrReader)."""

    def __init__(self):
        self.parts = bytearray(b"\x00\x01\x00\x00")

    def _align(self, size: int):
        off = (len(self.parts) - 4) % size
        if off:
            self.parts += b"\x00" * (size - off)

    def _pack(self, fmt: str, size: int, v):
        self._align(size)
        self.parts += struct.pack("<" + fmt, v)

    def uint8(self, v):
        self._pack("B", 1, v)

    def int32(self, v):
        self._pack("i", 4, v)

    def uint32(self, v):
        self._pack("I", 4, v)

    def float64(self, v):
        self._pack("d", 8, float(v))

    def float64_array(self, a):
        self._align(8)
        self.parts += np.asarray(a, "<f8").tobytes()

    def string(self, s: str):
        b = s.encode("utf-8") + b"\x00"
        self.uint32(len(b))
        self.parts += b

    def bytes_seq(self, b: bytes):
        self.uint32(len(b))
        self.parts += bytes(b)

    def header(self, t: float, frame_id: str):
        sec = int(t)
        self.int32(sec)
        self.uint32(int(round((t - sec) * 1e9)))
        self.string(frame_id)

    def tobytes(self) -> bytes:
        return bytes(self.parts)


def encode_image(img: np.ndarray, t: float, frame_id: str = "camera") -> bytes:
    """Grayscale array → sensor_msgs/msg/Image (mono8) CDR payload."""
    arr = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
    h, w = arr.shape
    c = CdrWriter()
    c.header(t, frame_id)
    c.uint32(h)
    c.uint32(w)
    c.string("mono8")
    c.uint8(0)          # is_bigendian
    c.uint32(w)         # step
    c.bytes_seq(arr.tobytes())
    return c.tobytes()


def encode_imu(gyro, acc, t: float, frame_id: str = "imu",
               quat=(0.0, 0.0, 0.0, 1.0)) -> bytes:
    c = CdrWriter()
    c.header(t, frame_id)
    c.float64_array(list(quat))
    c.float64_array([0.0] * 9)
    c.float64_array(list(gyro))
    c.float64_array([0.0] * 9)
    c.float64_array(list(acc))
    c.float64_array([0.0] * 9)
    return c.tobytes()


class Rosbag2Writer:
    """Write a rosbag2-compatible sqlite3 bag (one .db3 + metadata.yaml)."""

    def __init__(self, out_dir: str, bag_name: str = "bag"):
        os.makedirs(out_dir, exist_ok=True)
        self.dir = out_dir
        self.db_path = os.path.join(out_dir, f"{bag_name}_0.db3")
        self.con = sqlite3.connect(self.db_path)
        self.con.executescript(
            "CREATE TABLE topics(id INTEGER PRIMARY KEY, name TEXT NOT NULL,"
            " type TEXT NOT NULL, serialization_format TEXT NOT NULL,"
            " offered_qos_profiles TEXT NOT NULL);"
            "CREATE TABLE messages(id INTEGER PRIMARY KEY,"
            " topic_id INTEGER NOT NULL, timestamp INTEGER NOT NULL,"
            " data BLOB NOT NULL);"
        )
        self._topic_ids = {}
        self._n = {}
        self._t_range = [None, None]

    def add_topic(self, name: str, type_: str) -> int:
        tid = len(self._topic_ids) + 1
        self.con.execute(
            "INSERT INTO topics VALUES (?, ?, ?, 'cdr', '')",
            (tid, name, type_))
        self._topic_ids[name] = tid
        self._n[name] = 0
        return tid

    def write(self, topic: str, t: float, payload: bytes):
        ts = int(round(t * 1e9))
        self.con.execute(
            "INSERT INTO messages(topic_id, timestamp, data) VALUES (?,?,?)",
            (self._topic_ids[topic], ts, payload))
        self._n[topic] += 1
        lo, hi = self._t_range
        self._t_range = [ts if lo is None else min(lo, ts),
                         ts if hi is None else max(hi, ts)]

    def close(self):
        self.con.commit()
        self.con.close()
        lo, hi = self._t_range
        lo = lo or 0
        hi = hi or 0
        # minimal metadata.yaml so `ros2 bag info/play` accepts the dir
        with open(os.path.join(self.dir, "metadata.yaml"), "w") as f:
            f.write(
                "rosbag2_bagfile_information:\n"
                "  version: 4\n"
                "  storage_identifier: sqlite3\n"
                f"  relative_file_paths:\n    - {os.path.basename(self.db_path)}\n"
                f"  duration:\n    nanoseconds: {hi - lo}\n"
                f"  starting_time:\n    nanoseconds_since_epoch: {lo}\n"
                f"  message_count: {sum(self._n.values())}\n"
                "  compression_format: \"\"\n"
                "  compression_mode: \"\"\n")


def replay_bag(system, path: str, image_topic: Optional[str] = None,
               imu_topic: Optional[str] = None,
               max_frames: Optional[int] = None):
    """Feed a bag through a System with the correct (t_prev, t_img] IMU
    interleave (the contract the reference wrapper got wrong — SURVEY §3.2).

    Returns the list of per-frame (t, T_cw) the system produced."""
    from orb_slam3_ros2_tpu_torch.runtime.system import ImuPoint

    reader = Rosbag2Reader(path)
    g_img, g_imu = reader.guess_topics()
    image_topic = image_topic or g_img
    imu_topic = imu_topic or g_imu
    if image_topic is None:
        raise ValueError("bag has no image topic")
    topics = [image_topic] + ([imu_topic] if imu_topic else [])

    out = []
    pending_imu: List[ImuPoint] = []
    n = 0
    for name, _bag_t, msg in reader.messages(topics):
        if name == imu_topic:
            pending_imu.append(ImuPoint(msg.acc, msg.gyro, msg.t))
            continue
        imu_pts, pending_imu = pending_imu, []
        T = system.track_monocular(msg.data, msg.t, imu_pts)
        out.append((msg.t, T))
        n += 1
        if max_frames and n >= max_frames:
            break
    return out
