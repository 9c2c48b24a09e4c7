"""
The cameras (the JAX package's geometry/camera.py `Camera`,
`FisheyeCamera`, `image_grid`, `scale_intrinsics`):
- pinhole: Kinv lifting of depth to points and projection to
  grid_sample's [-1, 1] coordinates, with the +0.5/-0.5 pixel-centre rule
  when intrinsics are rescaled;
- VADAS fisheye: theta = atan(r), the 7-term polynomial theta -> r_d in
  Horner form, scales s / div and the principal point ux / uy; its
  reconstruction takes theta ~= r_d (the reference's approximate
  inverse). The JAX numerics are kept: the +1e-18 inside the projection's
  sqrt (sqrt's gradient at 0 is infinite; the floor moves the value only
  on the principal-point ray), the radius floored at the dtype's epsilon,
  the depth clipped at that epsilon.

Layout: depth maps are [B,H,W,1], points [B,H,W,3], intrinsics [B,3,3].
"""

import torch

from packnet_sfm_tpu_torch.geometry.pose import Pose


def image_grid(B, H, W, dtype=torch.float32, device=None):
    """Homogeneous pixel grid [B,H,W,3] of (u=x, v=y, 1)."""
    xs = torch.arange(W, dtype=dtype, device=device)
    ys = torch.arange(H, dtype=dtype, device=device)
    u = xs[None, :].expand(H, W)
    v = ys[:, None].expand(H, W)
    grid = torch.stack([u, v, torch.ones_like(u)], dim=-1)
    return grid[None].expand(B, H, W, 3)


def scale_intrinsics(K, x_scale, y_scale):
    """Scale [B,3,3] intrinsics (pixel-centre convention)."""
    K = K.clone()
    K[..., 0, 0] = K[..., 0, 0] * x_scale
    K[..., 1, 1] = K[..., 1, 1] * y_scale
    K[..., 0, 2] = (K[..., 0, 2] + 0.5) * x_scale - 0.5
    K[..., 1, 2] = (K[..., 1, 2] + 0.5) * y_scale - 0.5
    return K


class Camera:
    """Pinhole camera: intrinsics K [B,3,3] and the camera->world pose Tcw
    (identity when not given)."""

    def __init__(self, K, Tcw=None):
        if K.dim() == 2:
            K = K[None]
        self.K = K
        self.Tcw = Tcw if Tcw is not None else Pose.identity(
            K.shape[0], K.dtype, K.device)

    @property
    def fx(self):
        return self.K[:, 0, 0]

    @property
    def fy(self):
        return self.K[:, 1, 1]

    @property
    def cx(self):
        return self.K[:, 0, 2]

    @property
    def cy(self):
        return self.K[:, 1, 2]

    @property
    def Twc(self):
        return self.Tcw.inverse()

    @property
    def Kinv(self):
        """Closed-form inverse of the calibration matrix."""
        zeros, ones = torch.zeros_like(self.fx), torch.ones_like(self.fx)
        row0 = torch.stack([1.0 / self.fx, zeros, -self.cx / self.fx], dim=-1)
        row1 = torch.stack([zeros, 1.0 / self.fy, -self.cy / self.fy], dim=-1)
        row2 = torch.stack([zeros, zeros, ones], dim=-1)
        return torch.stack([row0, row1, row2], dim=1).to(self.K.dtype)

    def reconstruct(self, depth, frame='w'):
        """Lift [B,H,W,1] depth to [B,H,W,3] points in the camera ('c') or
        world ('w') frame."""
        B, H, W, _ = depth.shape
        grid = image_grid(B, H, W, depth.dtype, depth.device)
        Xc = torch.einsum('bij,bhwj->bhwi', self.Kinv, grid) * depth
        if frame == 'c':
            return Xc
        if frame == 'w':
            return self.Twc @ Xc
        raise ValueError('Unknown reference frame {}'.format(frame))

    def project(self, X, frame='w'):
        """Project [B,H,W,3] points to normalised [-1, 1] coordinates
        [B,H,W,2]; the depth is clipped at 1e-5 before the division."""
        B, H, W, _ = X.shape
        if frame == 'w':
            Xc = self.Tcw @ X
        elif frame == 'c':
            Xc = X
        else:
            raise ValueError('Unknown reference frame {}'.format(frame))
        pix = torch.einsum('bij,bhwj->bhwi', self.K, Xc)
        Z = pix[..., 2].clamp(min=1e-5)
        Xn = 2.0 * (pix[..., 0] / Z) / (W - 1) - 1.0
        Yn = 2.0 * (pix[..., 1] / Z) / (H - 1) - 1.0
        return torch.stack([Xn, Yn], dim=-1)


class FisheyeCamera:
    """VADAS fisheye camera: polynomial k [B,7], scales s and div [B], the
    principal point ux, uy [B], the camera->world pose Tcw, and the
    (H, W) that projections normalise by (`image_size`; the points' own
    size when None)."""

    def __init__(self, k, s, div, ux, uy, Tcw, image_size=None):
        self.k, self.s, self.div, self.ux, self.uy = k, s, div, ux, uy
        self.Tcw = Tcw
        self.image_size = image_size

    @classmethod
    def create(cls, intrinsics, Tcw=None, image_size=None):
        """From a dict of k ([7] or [B,7]) and s, div, ux, uy (scalars or
        [B])."""
        k = torch.as_tensor(intrinsics['k'])
        if k.dim() == 1:
            k = k[None]
        B = k.shape[0]

        def vec(x):
            return torch.as_tensor(x, device=k.device).reshape(-1).expand(B)

        if Tcw is None:
            Tcw = Pose.identity(B, k.dtype, k.device)
        return cls(k, vec(intrinsics['s']), vec(intrinsics['div']),
                   vec(intrinsics['ux']), vec(intrinsics['uy']), Tcw,
                   image_size)

    @property
    def Twc(self):
        return self.Tcw.inverse()

    def scaled_to(self, DH, DW, H, W):
        """The camera of a (DH, DW) pyramid level of an (H, W) image: the
        principal point rescaled by the pixel-centre rule."""
        sw, sh = DW / float(W), DH / float(H)
        return FisheyeCamera(self.k, self.s, self.div,
                             (self.ux + 0.5) * sw - 0.5,
                             (self.uy + 0.5) * sh - 0.5, self.Tcw, (DH, DW))

    def reconstruct(self, depth, frame='w'):
        """Lift [B,H,W,1] depth to [B,H,W,3] points through the
        approximate inverse projection (theta ~= r_d)."""
        B, H, W, _ = depth.shape
        grid = image_grid(B, H, W, depth.dtype, depth.device)
        x_dist = (grid[..., 0] - self.ux[:, None, None]) / \
            self.s[:, None, None]
        y_dist = (grid[..., 1] - self.uy[:, None, None]) / \
            self.div[:, None, None]
        r_d = torch.sqrt(x_dist ** 2 + y_dist ** 2)
        r = torch.tan(r_d)
        r_d_safe = r_d.clamp(min=torch.finfo(depth.dtype).eps)
        d = depth[..., 0]
        Xc = torch.stack([(r / r_d_safe) * x_dist * d,
                          (r / r_d_safe) * y_dist * d, d], dim=-1)
        if frame == 'c':
            return Xc
        if frame == 'w':
            return self.Twc @ Xc
        raise ValueError('Unknown reference frame {}'.format(frame))

    def project(self, X, frame='w'):
        """Project [B,H,W,3] points to normalised [-1, 1] coordinates
        [B,H,W,2] through the VADAS polynomial."""
        B, H, W, _ = X.shape
        if self.image_size is not None:
            H, W = self.image_size
        if frame == 'w':
            Xc = self.Tcw @ X
        elif frame == 'c':
            Xc = X
        else:
            raise ValueError('Unknown reference frame {}'.format(frame))
        eps = torch.finfo(X.dtype).eps
        Z = Xc[..., 2].clamp(min=eps)
        x_norm = Xc[..., 0] / Z
        y_norm = Xc[..., 1] / Z
        r = torch.sqrt(x_norm ** 2 + y_norm ** 2 + 1e-18)
        theta = torch.atan(r)
        k = self.k
        r_d = k[:, 6][:, None, None]
        for i in range(5, -1, -1):
            r_d = r_d * theta + k[:, i][:, None, None]
        r_safe = r.clamp(min=eps)
        u = self.s[:, None, None] * ((r_d / r_safe) * x_norm) + \
            self.ux[:, None, None]
        v = self.div[:, None, None] * ((r_d / r_safe) * y_norm) + \
            self.uy[:, None, None]
        return torch.stack([2.0 * u / (W - 1) - 1.0,
                            2.0 * v / (H - 1) - 1.0], dim=-1)
