"""CTRV unscented Kalman filter (numpy).

The port's copy of ``mv3d_tpu/tracking/ukf.py``: a clean-room
equivalent of the reference's C++ UKF (src/UKF_Python_to_C++/
classA.cpp:10-426, exposed over ctypes): constant turn-rate & velocity
state [px, py, v, yaw, yaw_rate], lidar position measurements. Used for
offline tracklet smoothing; not on the detection path.
"""

from __future__ import annotations

import numpy as np

N_X = 5          # state: px, py, v, yaw, yawd
N_AUG = 7        # + longitudinal accel noise, yaw accel noise


def _norm_angle(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


class UnscentedKalmanFilter:
    def __init__(self, std_a: float = 2.0, std_yawdd: float = 0.6,
                 std_laspx: float = 0.15, std_laspy: float = 0.15):
        self.x = np.zeros(N_X)
        self.P = np.eye(N_X)
        self.std_a = std_a
        self.std_yawdd = std_yawdd
        self.R_lidar = np.diag([std_laspx ** 2, std_laspy ** 2])
        self.lam = 3.0 - N_AUG
        w = np.full(2 * N_AUG + 1, 0.5 / (self.lam + N_AUG))
        w[0] = self.lam / (self.lam + N_AUG)
        self.weights = w
        self.initialized = False

    def init_from_measurement(self, px: float, py: float):
        self.x = np.array([px, py, 0.0, 0.0, 0.0])
        self.P = np.eye(N_X)
        self.initialized = True

    # -- prediction -----------------------------------------------------------

    def _augmented_sigma_points(self):
        x_aug = np.zeros(N_AUG)
        x_aug[:N_X] = self.x
        P_aug = np.zeros((N_AUG, N_AUG))
        P_aug[:N_X, :N_X] = self.P
        P_aug[5, 5] = self.std_a ** 2
        P_aug[6, 6] = self.std_yawdd ** 2
        L = np.linalg.cholesky(P_aug + 1e-9 * np.eye(N_AUG))
        pts = np.zeros((2 * N_AUG + 1, N_AUG))
        pts[0] = x_aug
        s = np.sqrt(self.lam + N_AUG)
        for i in range(N_AUG):
            pts[1 + i] = x_aug + s * L[:, i]
            pts[1 + N_AUG + i] = x_aug - s * L[:, i]
        return pts

    @staticmethod
    def _ctrv_process(pt, dt):
        px, py, v, yaw, yawd, nu_a, nu_yawdd = pt
        if abs(yawd) > 1e-3:
            px_p = px + v / yawd * (np.sin(yaw + yawd * dt) - np.sin(yaw))
            py_p = py + v / yawd * (np.cos(yaw) - np.cos(yaw + yawd * dt))
        else:
            px_p = px + v * dt * np.cos(yaw)
            py_p = py + v * dt * np.sin(yaw)
        v_p = v
        yaw_p = yaw + yawd * dt
        yawd_p = yawd
        # add noise
        px_p += 0.5 * nu_a * dt * dt * np.cos(yaw)
        py_p += 0.5 * nu_a * dt * dt * np.sin(yaw)
        v_p += nu_a * dt
        yaw_p += 0.5 * nu_yawdd * dt * dt
        yawd_p += nu_yawdd * dt
        return np.array([px_p, py_p, v_p, yaw_p, yawd_p])

    def predict(self, dt: float):
        pts = self._augmented_sigma_points()
        self.Xsig = np.stack([self._ctrv_process(p, dt) for p in pts])
        x = np.sum(self.weights[:, None] * self.Xsig, axis=0)
        P = np.zeros((N_X, N_X))
        for i in range(len(self.weights)):
            d = self.Xsig[i] - x
            d[3] = _norm_angle(d[3])
            P += self.weights[i] * np.outer(d, d)
        self.x, self.P = x, P
        self.x[3] = _norm_angle(self.x[3])

    # -- update ---------------------------------------------------------------

    def update_lidar(self, z):
        """z = [px, py]."""
        Zsig = self.Xsig[:, 0:2]
        z_pred = np.sum(self.weights[:, None] * Zsig, axis=0)
        S = self.R_lidar.copy()
        T = np.zeros((N_X, 2))
        for i in range(len(self.weights)):
            dz = Zsig[i] - z_pred
            dx = self.Xsig[i] - self.x
            dx[3] = _norm_angle(dx[3])
            S += self.weights[i] * np.outer(dz, dz)
            T += self.weights[i] * np.outer(dx, dz)
        K = T @ np.linalg.inv(S)
        innov = np.asarray(z) - z_pred
        self.x = self.x + K @ innov
        self.x[3] = _norm_angle(self.x[3])
        self.P = self.P - K @ S @ K.T
        # normalized innovation squared (consistency check)
        return float(innov @ np.linalg.inv(S) @ innov)

    def step(self, z, dt: float):
        if not self.initialized:
            self.init_from_measurement(z[0], z[1])
            return 0.0
        self.predict(dt)
        return self.update_lidar(z)
