// Thick polylines on a uint8 RGB canvas, pixel for pixel as OpenCV's
// cv::polylines(img, pts, closed, color, thickness) draws them with
// integer points, LINE_8 and shift 0 (imgproc/src/drawing.cpp: PolyLine ->
// ThickLine -> FillConvexPoly + Line2 for each segment, Circle at the
// joints and caps).  The stickman of the landmark datasets is such a
// drawing (thickness 2), so the loaders need no cv2.
//
// Coordinates are 16.16 fixed point inside a segment, as in OpenCV; points
// may lie off the canvas and a segment's two ends may coincide.  As
// OpenCV 5.0 does, each segment is first clipped to the canvas widened by
// the thickness on every side (a segment that crosses the canvas's edge
// draws from the clipped ends).
//
// API (extern "C"):
//   int lpr_polylines_u8(uint8_t* img, int h, int w, const int32_t* pts,
//                        const int32_t* counts, const int32_t* closed,
//                        const uint8_t* colors, int n_lines, int thickness)
//     draws n_lines polylines in order: line i has counts[i] (x, y) points
//     taken in turn from pts, closed[i] != 0 joins its last point to its
//     first, colors[3 i .. 3 i + 2] is its RGB colour.  Returns 0, or -1
//     for a thickness below 2 (OpenCV's one-pixel line is another routine).

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kShift = 16;
constexpr int64_t kOne = int64_t(1) << kShift;

struct Pt {
  int64_t x, y;
};

struct Canvas {
  uint8_t* data;
  int h, w;
  const uint8_t* color;

  void put(int x, int y) const {
    if (0 <= x && x < w && 0 <= y && y < h)
      std::memcpy(data + (size_t(y) * w + x) * 3, color, 3);
  }
  // pixels [x1, x2] of row y, all on the canvas
  void hline(int y, int x1, int x2) const {
    uint8_t* row = data + size_t(y) * w * 3;
    for (int x = x1; x <= x2; ++x) std::memcpy(row + x * 3, color, 3);
  }
};

// cv::clipLine(Size2l, Point2l&, Point2l&)
bool clip_line(int64_t width, int64_t height, Pt& p1, Pt& p2) {
  if (width <= 0 || height <= 0) return false;
  const int64_t right = width - 1, bottom = height - 1;
  int64_t &x1 = p1.x, &y1 = p1.y, &x2 = p2.x, &y2 = p2.y;
  int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
  int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
  if ((c1 & c2) == 0 && (c1 | c2) != 0) {
    int64_t a;
    if (c1 & 12) {
      a = c1 < 8 ? 0 : bottom;
      x1 += (int64_t)((double)(a - y1) * (x2 - x1) / (y2 - y1));
      y1 = a;
      c1 = (x1 < 0) + (x1 > right) * 2;
    }
    if (c2 & 12) {
      a = c2 < 8 ? 0 : bottom;
      x2 += (int64_t)((double)(a - y2) * (x2 - x1) / (y2 - y1));
      y2 = a;
      c2 = (x2 < 0) + (x2 > right) * 2;
    }
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
      if (c1) {
        a = c1 == 1 ? 0 : right;
        y1 += (int64_t)((double)(a - x1) * (y2 - y1) / (x2 - x1));
        x1 = a;
        c1 = 0;
      }
      if (c2) {
        a = c2 == 1 ? 0 : right;
        y2 += (int64_t)((double)(a - x2) * (y2 - y1) / (x2 - x1));
        x2 = a;
        c2 = 0;
      }
    }
  }
  return (c1 | c2) == 0;
}

// Line2: the 8-connected line between two 16.16 points
void line2(const Canvas& c, Pt p1, Pt p2) {
  if (!clip_line(int64_t(c.w) << kShift, int64_t(c.h) << kShift, p1, p2))
    return;
  int64_t dx = p2.x - p1.x, dy = p2.y - p1.y;
  const int64_t j = dx < 0 ? -1 : 0, i = dy < 0 ? -1 : 0;
  const int64_t ax = (dx ^ j) - j, ay = (dy ^ i) - i;
  int64_t x_step, y_step;
  int ecount;
  if (ax > ay) {
    dy = (dy ^ j) - j;
    p1.x ^= p2.x & j; p2.x ^= p1.x & j; p1.x ^= p2.x & j;
    p1.y ^= p2.y & j; p2.y ^= p1.y & j; p1.y ^= p2.y & j;
    x_step = kOne;
    y_step = (dy * kOne) / (ax | 1);
    ecount = (int)((p2.x - p1.x) >> kShift);
  } else {
    dx = (dx ^ i) - i;
    p1.x ^= p2.x & i; p2.x ^= p1.x & i; p1.x ^= p2.x & i;
    p1.y ^= p2.y & i; p2.y ^= p1.y & i; p1.y ^= p2.y & i;
    x_step = (dx * kOne) / (ay | 1);
    y_step = kOne;
    ecount = (int)((p2.y - p1.y) >> kShift);
  }
  p1.x += kOne >> 1;
  p1.y += kOne >> 1;
  c.put((int)((p2.x + (kOne >> 1)) >> kShift),
        (int)((p2.y + (kOne >> 1)) >> kShift));
  if (ax > ay) {
    p1.x >>= kShift;
    for (; ecount >= 0; --ecount) {
      c.put((int)p1.x, (int)(p1.y >> kShift));
      p1.x++;
      p1.y += y_step;
    }
  } else {
    p1.y >>= kShift;
    for (; ecount >= 0; --ecount) {
      c.put((int)(p1.x >> kShift), (int)p1.y);
      p1.x += x_step;
      p1.y++;
    }
  }
  (void)x_step;
}

// FillConvexPoly with 16.16 vertices and an 8-connected outline
void fill_convex_poly(const Canvas& c, const Pt* v, int npts) {
  struct Edge {
    int idx, di;
    int64_t x, dx;
    int ye;
  } edge[2];
  const int64_t delta = kOne >> 1;
  const int64_t delta1 = kOne >> 1, delta2 = kOne >> 1;
  int imin = 0, edges = npts;
  int64_t xmin = v[0].x, xmax = v[0].x, ymin = v[0].y, ymax = v[0].y;
  Pt p0 = v[npts - 1];
  for (int i = 0; i < npts; ++i) {
    const Pt p = v[i];
    if (p.y < ymin) {
      ymin = p.y;
      imin = i;
    }
    if (p.y > ymax) ymax = p.y;
    if (p.x > xmax) xmax = p.x;
    if (p.x < xmin) xmin = p.x;
    line2(c, p0, p);
    p0 = p;
  }
  xmin = (xmin + delta) >> kShift;
  xmax = (xmax + delta) >> kShift;
  ymin = (ymin + delta) >> kShift;
  ymax = (ymax + delta) >> kShift;
  if (npts < 3 || (int)xmax < 0 || (int)ymax < 0 || (int)xmin >= c.w ||
      (int)ymin >= c.h)
    return;
  if (ymax > c.h - 1) ymax = c.h - 1;
  edge[0].idx = edge[1].idx = imin;
  int y = (int)ymin;
  edge[0].ye = edge[1].ye = y;
  edge[0].di = 1;
  edge[1].di = npts - 1;
  edge[0].x = edge[1].x = -kOne;
  edge[0].dx = edge[1].dx = 0;
  do {
    for (int i = 0; i < 2; ++i) {
      if (y >= edge[i].ye) {
        int idx0 = edge[i].idx, di = edge[i].di;
        int idx = idx0 + di;
        if (idx >= npts) idx -= npts;
        for (; edges-- > 0;) {
          const int ty = (int)((v[idx].y + delta) >> kShift);
          if (ty > y) {
            const int64_t xs = v[idx0].x, xe = v[idx].x;
            edge[i].ye = ty;
            edge[i].dx = ((xe - xs) * 2 + ((int64_t)ty - y)) /
                         (2 * ((int64_t)ty - y));
            edge[i].x = xs;
            edge[i].idx = idx;
            break;
          }
          idx0 = idx;
          idx += di;
          if (idx >= npts) idx -= npts;
        }
      }
    }
    if (edges < 0) break;
    if (y >= 0) {
      int left = 0, right = 1;
      if (edge[0].x > edge[1].x) {
        left = 1;
        right = 0;
      }
      int xx1 = (int)((edge[left].x + delta1) >> kShift);
      int xx2 = (int)((edge[right].x + delta2) >> kShift);
      if (xx2 >= 0 && xx1 < c.w) {
        if (xx1 < 0) xx1 = 0;
        if (xx2 >= c.w) xx2 = c.w - 1;
        c.hline(y, xx1, xx2);
      }
    }
    edge[0].x += edge[0].dx;
    edge[1].x += edge[1].dx;
  } while (++y <= (int)ymax);
}

// Circle(img, center, radius, color, fill=1): the filled midpoint disc
void filled_circle(const Canvas& c, int cx, int cy, int radius) {
  int err = 0, dx = radius, dy = 0, plus = 1, minus = (radius << 1) - 1;
  const bool inside = cx >= radius && cx < c.w - radius && cy >= radius &&
                      cy < c.h - radius;
  while (dx >= dy) {
    const int y11 = cy - dy, y12 = cy + dy, y21 = cy - dx, y22 = cy + dx;
    int x11 = cx - dx, x12 = cx + dx, x21 = cx - dy, x22 = cx + dy;
    if (inside) {
      c.hline(y11, x11, x12);
      c.hline(y12, x11, x12);
      c.hline(y21, x21, x22);
      c.hline(y22, x21, x22);
    } else if (x11 < c.w && x12 >= 0 && y21 < c.h && y22 >= 0) {
      if (x11 < 0) x11 = 0;
      if (x12 > c.w - 1) x12 = c.w - 1;
      if ((unsigned)y11 < (unsigned)c.h) c.hline(y11, x11, x12);
      if ((unsigned)y12 < (unsigned)c.h) c.hline(y12, x11, x12);
      if (x21 < c.w && x22 >= 0) {
        if (x21 < 0) x21 = 0;
        if (x22 > c.w - 1) x22 = c.w - 1;
        if ((unsigned)y21 < (unsigned)c.h) c.hline(y21, x21, x22);
        if ((unsigned)y22 < (unsigned)c.h) c.hline(y22, x21, x22);
      }
    }
    dy++;
    err += plus;
    plus += 2;
    const int mask = (err <= 0) - 1;
    err -= minus & mask;
    dx += mask;
    minus -= mask & 2;
  }
}

// ThickLine for thickness > 1: the segment's rectangle, then a disc at the
// ends that ``flags`` names (bit 0: p0, bit 1: p1)
void thick_line(const Canvas& c, Pt p0, Pt p1, int thickness, int flags) {
  {
    // the segment clipped to the canvas widened by the thickness on every
    // side (integer points): nothing of a segment outside it shows
    const int64_t m = thickness;
    Pt q0 = {p0.x + m, p0.y + m}, q1 = {p1.x + m, p1.y + m};
    if (!clip_line(c.w + 2 * m, c.h + 2 * m, q0, q1)) return;
    p0 = {q0.x - m, q0.y - m};
    p1 = {q1.x - m, q1.y - m};
  }
  p0.x <<= kShift; p0.y <<= kShift;
  p1.x <<= kShift; p1.y <<= kShift;
  const double inv_one = 1.0 / double(kOne);
  const double dx = (p0.x - p1.x) * inv_one, dy = (p1.y - p0.y) * inv_one;
  double r = dx * dx + dy * dy;
  const int odd = thickness & 1;
  thickness <<= kShift - 1;
  if (std::fabs(r) > 2.220446049250313e-16) {
    r = (thickness + odd * kOne * 0.5) / std::sqrt(r);
    const Pt dp = {(int64_t)std::lrint(dy * r), (int64_t)std::lrint(dx * r)};
    const Pt pt[4] = {{p0.x + dp.x, p0.y + dp.y},
                      {p0.x - dp.x, p0.y - dp.y},
                      {p1.x - dp.x, p1.y - dp.y},
                      {p1.x + dp.x, p1.y + dp.y}};
    fill_convex_poly(c, pt, 4);
  }
  for (int i = 0; i < 2; ++i) {
    if (flags & (i + 1)) {
      const int cx = (int)((p0.x + (kOne >> 1)) >> kShift);
      const int cy = (int)((p0.y + (kOne >> 1)) >> kShift);
      filled_circle(c, cx, cy, (int)((thickness + (kOne >> 1)) >> kShift));
    }
    p0 = p1;
  }
}

// PolyLine: every segment in order, a disc at each joint, and at both
// ends of an open line
void polyline(const Canvas& c, const int32_t* pts, int count, bool closed,
              int thickness) {
  if (count <= 0) return;
  int i = closed ? count - 1 : 0;
  int flags = 2 + !closed;
  Pt p0 = {pts[2 * i], pts[2 * i + 1]};
  for (i = !closed; i < count; ++i) {
    const Pt p = {pts[2 * i], pts[2 * i + 1]};
    thick_line(c, p0, p, thickness, flags);
    p0 = p;
    flags = 2;
  }
}

}  // namespace

extern "C" {

int lpr_polylines_u8(uint8_t* img, int h, int w, const int32_t* pts,
                     const int32_t* counts, const int32_t* closed,
                     const uint8_t* colors, int n_lines, int thickness) {
  if (thickness < 2) return -1;
  for (int i = 0; i < n_lines; ++i) {
    const Canvas c = {img, h, w, colors + 3 * i};
    polyline(c, pts, counts[i], closed[i] != 0, thickness);
    pts += 2 * counts[i];
  }
  return 0;
}

}  // extern "C"
