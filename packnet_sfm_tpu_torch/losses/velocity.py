"""
Velocity supervision (the JAX package's losses/velocity.py; reference
losses/velocity_loss.py): the L1 distance between the predicted and the
ground-truth translation magnitudes, averaged over the batch and the
contexts.
"""


def velocity_loss(pred_poses, gt_pose_context):
    """pred_poses: list of Pose; gt_pose_context: list of [B,4,4] tensors.
    Returns {'loss', 'metrics': {'velocity_loss'}}."""
    total = 0.0
    for pred, gt in zip(pred_poses, gt_pose_context):
        pred_t = pred.mat[:, :3, 3].norm(dim=-1)
        gt_t = gt[:, :3, 3].norm(dim=-1)
        total = total + (pred_t - gt_t).abs().mean()
    loss = total / len(gt_pose_context)
    return {'loss': loss, 'metrics': {'velocity_loss': loss}}
